"""GNN layers: GCN, GraphSAGE, GAT and GGNN with the l2norm/dense head,
and the reference init.

Counterpart of ``graphaibench_tpu/nn/layers.py``. ``ModelConfig`` and
``make_config`` are the port's own copies (it imports nothing of the JAX
package) with every field and default, so the two configs compare equal. Forward
semantics follow the reference, including the y>z order optimization
that chooses GEMM-then-SpMM or SpMM-then-GEMM (gcn_layer.cpp:19-25);
gradients come from autograd, with hand-written adjoints for the sparse
ops (``ops/spmm.py``, ``ops/fused_gat.py``). Parameters live in an
``nn.Module`` whose names keep the JAX pytree's paths
(``gconv.{l}.W_neigh``, ``.W_self``, ``.alpha_l``, ``.Wz`` ..., ``dense.W``)
and are initialized with the reference's deterministic Glorot seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.fused_gat import (
    gat_attention_spmm,
    gat_attention_spmm_v2,
)
from graphaibench_tpu_torch.ops.rng import glorot_reference
from graphaibench_tpu_torch.ops.segment import segment_softmax
from graphaibench_tpu_torch.ops.spmm import _pick_impl, sddmm_add, spmm

# Full float32 GEMMs, no TF32: the reference runs its GEMMs at
# Precision.HIGHEST, and TF32 keeps about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The architecture and its hyper-parameters as a runtime value."""

    arch: str                 # "gcn" | "sage" | "gat" | "ggnn"
    num_layers: int
    dim_init: int
    dim_hid: int
    num_cls: int
    feat_drop: float = 0.0
    score_drop: float = 0.0
    is_sigmoid: bool = False
    use_l2norm: bool = False
    use_dense: bool = False
    lr: float = 0.02
    spmm_impl: str = "auto"
    optimizer: str = "adam"
    # rematerialize each gconv layer in the backward pass
    remat: bool = False

    def __post_init__(self):
        if self.arch not in ("gcn", "sage", "gat", "ggnn"):
            raise ValueError(f"unknown arch {self.arch!r}")

    @property
    def gconv_dims(self) -> list[tuple[int, int, bool]]:
        """(dim_in, dim_out, is_act) per gconv layer — net.cpp:422-440."""
        dims = []
        for l in range(self.num_layers - 1):
            din = self.dim_init if l == 0 else self.dim_hid
            dims.append((din, self.dim_hid, True))
        dout = self.dim_hid if self.use_dense else self.num_cls
        last_in = self.dim_hid if self.num_layers > 1 else self.dim_init
        dims.append((last_in, dout, False))
        return dims


def make_config(arch: str, num_layers: int, dim_init: int, dim_hid: int,
                num_cls: int, *, subg_size: int = 0, **kw) -> ModelConfig:
    """The reference's auto-wiring: GAT/GGNN/sampling turn on the trailing
    l2norm+dense head (net.cpp:69-72); GGNN forces 1 layer."""
    if arch == "ggnn":
        num_layers = 1
    use_l2norm = kw.pop("use_l2norm", subg_size > 0 or arch in ("gat", "ggnn"))
    use_dense = kw.pop("use_dense", use_l2norm)
    return ModelConfig(
        arch=arch, num_layers=num_layers, dim_init=dim_init, dim_hid=dim_hid,
        num_cls=num_cls, use_l2norm=use_l2norm, use_dense=use_dense, **kw,
    )


# Parameter names of a gconv layer per architecture, in the JAX pytree's
# order of creation (graphaibench_tpu/nn/layers.py::init_params).
LAYER_PARAMS = {
    "gcn": ("W_neigh",),
    "sage": ("W_neigh", "W_self"),
    "gat": ("W_neigh", "alpha_l", "alpha_r"),
    "ggnn": ("W_neigh", "Wz", "Uz", "Wr", "Ur", "Wh", "Uh"),
}


class _GConv(nn.Module):
    """One gconv layer's parameters, under their names."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


class _Dense(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.W = nn.Parameter(w)


class GcnParams(nn.Module):
    """A model's parameters: ``gconv.{l}.<name>`` for the names of the
    architecture (``LAYER_PARAMS``) and, with the dense head,
    ``dense.W``. (The class keeps the name it had when GCN was the only
    architecture.)"""

    def __init__(self, gconv: list[dict[str, torch.Tensor]],
                 dense: Optional[torch.Tensor] = None):
        super().__init__()
        self.gconv = nn.ModuleList(_GConv(layer) for layer in gconv)
        self.dense = _Dense(dense) if dense is not None else None


def _layer_names(layer: dict) -> tuple:
    """The parameter names of one gconv layer in the port's order,
    whatever order the dict has them in."""
    for names in LAYER_PARAMS.values():
        if set(names) == set(layer):
            return names
    raise ValueError(f"parameters {sorted(layer)} are not those of a gcn, "
                     "sage, gat or ggnn layer")


def leaves_in_param_order(tree: dict) -> list:
    """The leaves of a pytree shaped like the JAX package's parameters
    (``{"gconv": [{name: leaf}], "dense": {"W": leaf}}``) in the order of
    ``GcnParams.parameters()``: layer by layer in ``LAYER_PARAMS`` order,
    then ``dense.W``."""
    leaves = [layer[name] for layer in tree["gconv"]
              for name in _layer_names(layer)]
    if tree.get("dense") is not None:
        leaves.append(tree["dense"]["W"])
    return leaves


def params_from_jax(params_np: dict, device) -> GcnParams:
    """The port's parameters from the JAX package's parameter pytree, as
    numpy arrays: ``{"gconv": [{"W_neigh": ..., ...}], "dense": {"W":
    ...}}``, for any of the four architectures."""

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    dense = params_np.get("dense")
    return GcnParams([{k: t(layer[k]) for k in _layer_names(layer)}
                      for layer in params_np["gconv"]],
                     t(dense["W"]) if dense is not None else None)


def init_params(cfg: ModelConfig, *, device) -> GcnParams:
    """Deterministic reference initialization: seed 1 for every W_neigh
    and the dense W (graph_conv_layer.cpp:12-19), seed 2 for SAGE's
    W_self, seeds 2/3 for GAT's attention vectors (column 0 of a
    (dout, 1) Glorot), seeds 3-8 for GGNN's gate matrices."""
    layers = []
    for (din, dout, _act) in cfg.gconv_dims:
        p = {"W_neigh": glorot_reference(din, dout, 1)}
        if cfg.arch == "sage":
            p["W_self"] = glorot_reference(din, dout, 2)
        elif cfg.arch == "gat":
            p["alpha_l"] = glorot_reference(dout, 1, 2)[:, 0]
            p["alpha_r"] = glorot_reference(dout, 1, 3)[:, 0]
        elif cfg.arch == "ggnn":
            # GRU gates (z, r, candidate) — reference ggnn_aggregator.cu
            for name, seed in (("Wz", 3), ("Uz", 4), ("Wr", 5),
                               ("Ur", 6), ("Wh", 7), ("Uh", 8)):
                p[name] = glorot_reference(dout, dout, seed)
        layers.append(p)
    tree = {"gconv": layers}
    if cfg.use_dense:
        tree["dense"] = {"W": glorot_reference(cfg.dim_hid, cfg.num_cls, 1)}
    return params_from_jax(tree, device)


def _maybe_dropout(x, rate, train, generator):
    if train and rate > 0.0 and generator is not None:
        out, _ = gmath.dropout(generator, x, rate)
        return out
    return x


def _aggregate_and_project(p: _GConv, dg, edge_w, x, cfg):
    """A(x) W_neigh in the cheaper order: GEMM first when it narrows the
    rows the SpMM gathers (y > z, gcn_layer.cpp:19-25)."""
    y, z = x.shape[1], p.W_neigh.shape[1]
    if y > z:
        return spmm(dg, edge_w, matmul(x, p.W_neigh), cfg.spmm_impl)
    return matmul(spmm(dg, edge_w, x, cfg.spmm_impl), p.W_neigh)


def gcn_layer_fwd(p: _GConv, dg: DeviceGraph, edge_w, x, *, act, cfg,
                  train, generator, trivial_w=False):
    """gcn_layer.cpp:5-28 with the y>z order optimization."""
    x = _maybe_dropout(x, cfg.feat_drop, train, generator)
    out = _aggregate_and_project(p, dg, edge_w, x, cfg)
    return torch.relu(out) if act else out


def sage_layer_fwd(p: _GConv, dg: DeviceGraph, edge_w, x, *, act, cfg,
                   train, generator, trivial_w=False):
    """sage_layer.cpp:5-25: mean-aggregated neighbor path + separate
    self path, summed (the 'concat' accumulate-GEMM)."""
    x = _maybe_dropout(x, cfg.feat_drop, train, generator)
    out = _aggregate_and_project(p, dg, edge_w, x, cfg) + matmul(x, p.W_self)
    return torch.relu(out) if act else out


def gat_layer_fwd(p: _GConv, dg: DeviceGraph, edge_w, x, *, act, cfg,
                  train, generator, return_scores=False, trivial_w=False):
    """gat_layer.cpp:3-22 + gat_aggregator.cpp:57-102: project, rank-1
    edge logits a_l.h_src + a_r.h_dst, LeakyReLU(0.2), softmax over each
    source vertex's edge list, score-weighted aggregation.

    On the ELL strategy the softmax fuses into the aggregation: with
    ``trivial_w``, a static promise that ``edge_w`` is all ones, the
    logits are computed inside the bucket passes
    (``gat_attention_spmm_v2``); without it ``edge_w`` weighs or masks
    the edges (``gat_attention_spmm`` on per-edge logits). The unfused
    path serves ``return_scores``, score dropout and the other
    strategies."""
    x = _maybe_dropout(x, cfg.feat_drop, train, generator)
    h = matmul(x, p.W_neigh)
    sl = h @ p.alpha_l
    sr = h @ p.alpha_r
    drop_scores = train and cfg.score_drop > 0.0 and generator is not None
    if (dg.has_ell_layout and not (return_scores or drop_scores)
            and _pick_impl(dg, cfg.spmm_impl) == "ell"):
        if trivial_w:
            out = gat_attention_spmm_v2(dg, sl, sr, h)
        else:
            logits = gmath.leaky_relu(sddmm_add(dg, sl, sr), 0.2)
            out = gat_attention_spmm(dg, logits, edge_w, h)
        return torch.relu(out) if act else out
    logits = gmath.leaky_relu(sddmm_add(dg, sl, sr), 0.2)
    scores = segment_softmax(dg, logits) * edge_w
    if drop_scores:
        scores, _ = gmath.dropout(generator, scores, cfg.score_drop)
    out = spmm(dg, scores, h, cfg.spmm_impl)
    out = torch.relu(out) if act else out
    if return_scores:
        return out, scores
    return out


def ggnn_layer_fwd(p: _GConv, dg: DeviceGraph, edge_w, x, *, act, cfg,
                   train, generator, trivial_w=False):
    """Gated GNN (GRU over summed neighbor messages) — the reference's
    GGNN aggregator (ggnn_aggregator.cu) expressed densely:
    a = sum_nbr h; z = sig(aWz + hUz); r = sig(aWr + hUr);
    hcand = tanh(aWh + (r*h)Uh); h' = (1-z)*h + z*hcand. The input is
    projected by W_neigh only when its width is not the hidden width."""
    x = _maybe_dropout(x, cfg.feat_drop, train, generator)
    if x.shape[1] != p.W_neigh.shape[1]:
        x = matmul(x, p.W_neigh)
    a = spmm(dg, edge_w, x, cfg.spmm_impl)
    z = torch.sigmoid(matmul(a, p.Wz) + matmul(x, p.Uz))
    r = torch.sigmoid(matmul(a, p.Wr) + matmul(x, p.Ur))
    hcand = torch.tanh(matmul(a, p.Wh) + matmul(r * x, p.Uh))
    out = (1 - z) * x + z * hcand
    return torch.relu(out) if act else out


_LAYER_FWD = {
    "gcn": gcn_layer_fwd,
    "sage": sage_layer_fwd,
    "gat": gat_layer_fwd,
    "ggnn": ggnn_layer_fwd,
}


def _remat_layer(fwd, p: _GConv, dg, edge_w, h, *, generator, **kw):
    """One gconv layer under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward, as JAX's
    ``jax.checkpoint`` of the layer (graphaibench_tpu/nn/layers.py:247-251).

    The checkpoint restores only the global RNGs, and the layer's dropout
    masks come from ``generator``. So the layer draws from a generator of
    its own, set to ``generator``'s state on every call: the recompute draws
    the forward's masks. After the forward ``generator`` takes the local
    one's state, so that the next draws are those of a run without remat."""
    local = state = None
    if generator is not None:
        local = torch.Generator(device=generator.device)
        state = generator.get_state()

    def layer(h):
        if local is not None:
            local.set_state(state)
        return fwd(p, dg, edge_w, h, generator=local, **kw)

    # the layers draw only from ``local``: no global RNG state to keep
    out = torch.utils.checkpoint.checkpoint(layer, h, use_reentrant=False,
                                            preserve_rng_state=False)
    if local is not None:
        generator.set_state(local.get_state())
    return out


def apply_model(cfg: ModelConfig, params: GcnParams, dg: DeviceGraph,
                edge_w, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_intermediates: bool = False,
                trivial_w: bool = False):
    """Full forward pass: gconv stack [+ l2norm + dense] -> logits.
    Mirrors Model::forward_prop (net.cpp:457-502). ``generator`` draws
    the dropout masks when ``train`` and a drop rate is positive.
    ``trivial_w`` is a static promise that ``edge_w`` is all ones
    (full-batch graphs), which lets GAT compute its logits inside the
    fused attention; without it GAT's fused attention takes ``edge_w`` as
    per-edge weights or a mask. ``cfg.remat`` recomputes each gconv layer
    in the backward (``_remat_layer``) where autograd records the forward;
    with ``return_intermediates`` every activation is kept anyway, so
    ``cfg.remat`` is ignored there, as in the JAX package."""
    fwd = _LAYER_FWD[cfg.arch]
    remat = (cfg.remat and not return_intermediates
             and torch.is_grad_enabled())
    acts = []
    h = x
    for l, (_, _, act) in enumerate(cfg.gconv_dims):
        kw = dict(act=act, cfg=cfg, train=train, trivial_w=trivial_w)
        if remat:
            h = _remat_layer(fwd, params.gconv[l], dg, edge_w, h,
                             generator=generator, **kw)
        else:
            h = fwd(params.gconv[l], dg, edge_w, h, generator=generator, **kw)
        acts.append(h)
    if cfg.use_l2norm:
        h = gmath.l2norm_rows(h)
        acts.append(h)
    if cfg.use_dense:
        h = matmul(h, params.dense.W)
        acts.append(h)
    if return_intermediates:
        return h, acts
    return h
