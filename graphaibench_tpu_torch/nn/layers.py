"""GNN layers: GCN with the l2norm/dense head, and the reference init.

Counterpart of ``graphaibench_tpu/nn/layers.py``. ``ModelConfig`` and
``make_config`` are the port's own copies (it imports nothing of the JAX
package) with every field and default, so the two configs compare equal. Forward
semantics follow the reference, including the y>z order optimization
that chooses GEMM-then-SpMM or SpMM-then-GEMM (gcn_layer.cpp:19-25);
gradients come from autograd. Parameters live in an ``nn.Module`` whose
names keep the JAX pytree's paths (``gconv.{l}.W_neigh``, ``dense.W``)
and are initialized with the reference's deterministic Glorot seeds.

SAGE, GAT and GGNN are ROADMAP items P5, P7 and P8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.rng import glorot_reference
from graphaibench_tpu_torch.ops.spmm import spmm

# Full float32 GEMMs, no TF32: the reference runs its GEMMs at
# Precision.HIGHEST, and TF32 keeps about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_NOT_PORTED = {
    "sage": "GraphSAGE is not ported yet (ROADMAP queue 1, P5)",
    "gat": "GAT is not ported yet (ROADMAP queue 1, P7)",
    "ggnn": "GGNN is not ported yet (ROADMAP queue 1, P8)",
}


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


class _GConv(nn.Module):
    def __init__(self, w_neigh: torch.Tensor):
        super().__init__()
        self.W_neigh = nn.Parameter(w_neigh)


class _Dense(nn.Module):
    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.W = nn.Parameter(w)


class GcnParams(nn.Module):
    """GCN parameters: ``gconv.{l}.W_neigh`` and, with the dense head,
    ``dense.W``."""

    def __init__(self, gconv: list[torch.Tensor],
                 dense: Optional[torch.Tensor] = None):
        super().__init__()
        self.gconv = nn.ModuleList(_GConv(w) for w in gconv)
        self.dense = _Dense(dense) if dense is not None else None


def params_from_jax(params_np: dict, device) -> GcnParams:
    """The port's parameters from the JAX package's parameter pytree, as
    numpy arrays: ``{"gconv": [{"W_neigh": ...}], "dense": {"W": ...}}``."""
    for layer in params_np["gconv"]:
        extra = set(layer) - {"W_neigh"}
        if extra:
            raise NotImplementedError(
                f"parameters {sorted(extra)} belong to an architecture that "
                "is not ported yet (ROADMAP queue 1, P5/P7/P8)")

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    dense = params_np.get("dense")
    return GcnParams([t(p["W_neigh"]) for p in params_np["gconv"]],
                     t(dense["W"]) if dense is not None else None)


def init_params(cfg: ModelConfig, *, device) -> GcnParams:
    """Deterministic reference initialization (seed 1 for every W_neigh
    and the dense W, as graph_conv_layer.cpp:12-19)."""
    if cfg.arch != "gcn":
        raise NotImplementedError(_NOT_PORTED[cfg.arch])
    tree = {"gconv": [{"W_neigh": glorot_reference(din, dout, 1)}
                      for (din, dout, _act) in cfg.gconv_dims]}
    if cfg.use_dense:
        tree["dense"] = {"W": glorot_reference(cfg.dim_hid, cfg.num_cls, 1)}
    return params_from_jax(tree, device)


def _maybe_dropout(x, rate, train, generator):
    if train and rate > 0.0 and generator is not None:
        out, _ = gmath.dropout(generator, x, rate)
        return out
    return x


def gcn_layer_fwd(p: _GConv, dg: DeviceGraph, edge_w, x, *, act, cfg,
                  train, generator):
    """gcn_layer.cpp:5-28 with the y>z order optimization."""
    x = _maybe_dropout(x, cfg.feat_drop, train, generator)
    y, z = x.shape[1], p.W_neigh.shape[1]
    if y > z:
        h = matmul(x, p.W_neigh)
        out = spmm(dg, edge_w, h, cfg.spmm_impl)
    else:
        h = spmm(dg, edge_w, x, cfg.spmm_impl)
        out = matmul(h, p.W_neigh)
    return torch.relu(out) if act else out


def apply_model(cfg: ModelConfig, params: GcnParams, dg: DeviceGraph,
                edge_w, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_intermediates: bool = False):
    """Full forward pass: gconv stack [+ l2norm + dense] -> logits.
    Mirrors Model::forward_prop (net.cpp:457-502). ``generator`` draws
    the dropout masks when ``train`` and ``cfg.feat_drop > 0``."""
    if cfg.arch != "gcn":
        raise NotImplementedError(_NOT_PORTED[cfg.arch])
    if cfg.remat:
        raise NotImplementedError(
            "layer remat is not ported (ROADMAP queue 1, P11 measures "
            "whether 80 GB still needs it)")
    acts = []
    h = x
    for l, (_, _, act) in enumerate(cfg.gconv_dims):
        h = gcn_layer_fwd(params.gconv[l], dg, edge_w, h, act=act, cfg=cfg,
                          train=train, generator=generator)
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
