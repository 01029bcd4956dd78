"""Sparse matrix times dense matrix (SpMM) — the GNN aggregation.

out[s] = sum over edges (s -> d) of  w_e * X[d]      (row-gather form)

Counterpart of ``graphaibench_tpu/ops/spmm.py``, with the same three
strategies and the same choice between them:

  * ``coo``   — gather X by col_idx, index_add over edge_src (plain
                PyTorch; materializes an (E, F) intermediate).
  * ``ell``   — the degree-bucketed pass, kernel K1 on a CUDA device
                (``ops/ell_spmm.py``).
  * ``dense`` — the N x N weighted adjacency times X, for small graphs.

``spmm`` is differentiable through ``torch.autograd.Function``s: for the
structurally symmetric graphs GNNs aggregate over, the adjoint is the
same SpMM with transpose-permuted weights, and the weight gradient is an
SDDMM. Each gradient is computed only when autograd asks for it: in GCN
the first layer's input is the feature matrix, so its adjoint SpMM never
runs, and the static edge weights need no SDDMM.

Beside it the per-edge ops that GAT's unfused path and the weight
gradient run on: ``sddmm_dot`` (the kernel ``sddmm_dot_ell`` on a CUDA
graph with ELL buckets, the chunked plain dot elsewhere) and
``sddmm_add`` (GAT's rank-1 logits: plain PyTorch gathers, its adjoint two
row sums).
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph, PackedEdgeW
from graphaibench_tpu_torch.ops.ell_edge import sddmm_dot_ell
from graphaibench_tpu_torch.ops.ell_spmm import ell_spmm
from graphaibench_tpu_torch.ops.segment import _row_reduce_ell
from graphaibench_tpu_torch.utils.timers import span


def spmm_coo(g: DeviceGraph, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather + index_add path."""
    msgs = x[g.col_idx] * w[:, None]
    return x.new_zeros((g.nv, x.shape[1])).index_add_(0, g.edge_src, msgs)


def spmm_ell(g: DeviceGraph, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Degree-bucketed ELL path on (ne,) per-edge weights, gathered into
    slot order per bucket."""
    if not g.has_ell_layout:
        raise ValueError("DeviceGraph has no ELL buckets (no edges)")
    w_pad = torch.cat([w, w.new_zeros(1)])
    return ell_spmm(g, tuple(w_pad[b.edge_id] for b in g.ell), x)


def spmm_dense(g: DeviceGraph, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Materialize the weighted adjacency and multiply (full f32)."""
    a = x.new_zeros((g.nv, g.nv))
    a.index_put_((g.edge_src.long(), g.col_idx.long()), w, accumulate=True)
    return a @ x


_IMPLS = {"coo": spmm_coo, "ell": spmm_ell, "dense": spmm_dense}


def _pick_impl(g: DeviceGraph, impl: str) -> str:
    if impl != "auto":
        return impl
    if g.nv <= 4096:
        return "dense"
    return "ell" if g.has_ell_layout else "coo"


class _Spmm(torch.autograd.Function):
    """SpMM on (ne,) per-edge weights with the transpose adjoint."""

    @staticmethod
    def forward(ctx, g: DeviceGraph, impl: str, w, x):
        ctx.g, ctx.impl = g, impl
        ctx.save_for_backward(w, x if ctx.needs_input_grad[2] else None)
        return _IMPLS[impl](g, w, x)

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        w, x = ctx.saved_tensors
        dw = dx = None
        if ctx.needs_input_grad[3]:
            with span("gab.spmm.adjoint"):
                dx = _IMPLS[ctx.impl](g, w[g.trans_perm], ct.contiguous())
        if ctx.needs_input_grad[2]:
            dw = sddmm_dot(g, ct, x)
        return None, None, dw, dx


class _SpmmPacked(torch.autograd.Function):
    """ELL SpMM on pre-gathered static weights; the adjoint runs K1 on
    the packed transpose view. ``raw`` is ``wp.raw``, passed so that its
    gradient (an SDDMM) can be asked for."""

    @staticmethod
    def forward(ctx, g: DeviceGraph, wp: PackedEdgeW, raw, x):
        ctx.g, ctx.wp = g, wp
        ctx.save_for_backward(x if ctx.needs_input_grad[2] else None)
        return ell_spmm(g, wp.fwd, x)

    @staticmethod
    def backward(ctx, ct):
        g, wp = ctx.g, ctx.wp
        (x,) = ctx.saved_tensors
        dw = dx = None
        if ctx.needs_input_grad[3]:
            with span("gab.spmm.adjoint"):
                dx = ell_spmm(g, wp.t, ct.contiguous())
        if ctx.needs_input_grad[2]:
            dw = sddmm_dot(g, ct, x)
        return None, None, dw, dx


def spmm(g: DeviceGraph, w, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Differentiable SpMM. ``g`` must be structurally symmetric for the
    adjoint. ``w`` is a (ne,) per-edge array or a ``PackedEdgeW`` of
    static pre-gathered weights (the GCN path at scale)."""
    impl = _pick_impl(g, impl)
    if isinstance(w, PackedEdgeW):
        if impl == "ell":
            return _SpmmPacked.apply(g, w, w.raw, x)
        # an explicitly requested non-ELL strategy runs on the raw weights
        w = w.raw
    return _Spmm.apply(g, impl, w, x)


def sddmm_dot(g: DeviceGraph, a: torch.Tensor, b: torch.Tensor,
              chunk_elems: int = 1 << 28) -> torch.Tensor:
    """Per-edge dot product s_e = <a[src_e], b[dst_e]> — the SpMM weight
    gradient (gat_aggregator.cpp:106-113). On a CUDA graph with ELL
    buckets one kernel pass (``sddmm_dot_ell``), which materializes no
    (E, F) operand; elsewhere plain PyTorch, chunked over edges so that
    the two gathered (E, F) operands stay under ``chunk_elems`` elements
    each (about 1 GB)."""
    if a.is_cuda and g.has_ell_layout:
        return sddmm_dot_ell(g, a.contiguous(), b.contiguous())
    step = max(1, chunk_elems // max(a.shape[1], 1))
    if g.ne <= step:
        return (a[g.edge_src] * b[g.col_idx]).sum(1)
    return torch.cat([
        (a[g.edge_src[lo:lo + step]] * b[g.col_idx[lo:lo + step]]).sum(1)
        for lo in range(0, g.ne, step)])


class _SddmmAdd(torch.autograd.Function):
    """s_e = sa[src_e] + sb[dst_e]; the adjoint is two row sums over the
    CSR-ordered edge list, the destination side through the transpose
    permutation, instead of autograd's scatter by unsorted indices."""

    @staticmethod
    def forward(ctx, g: DeviceGraph, sa, sb):
        ctx.g = g
        return sa[g.edge_src] + sb[g.col_idx]

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        dsa = dsb = None
        if ctx.needs_input_grad[1]:
            dsa = _row_reduce_ell(g, ct, "sum")
        if ctx.needs_input_grad[2]:
            dsb = _row_reduce_ell(g, ct[g.trans_perm], "sum")
        return None, dsa, dsb


def sddmm_add(g: DeviceGraph, sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Per-edge s_e = sa[src_e] + sb[dst_e] (the GAT rank-1 attention
    logits, gat_aggregator.cpp:57-80). ``g`` must be structurally
    symmetric for the adjoint. The forward is two plain PyTorch gathers
    on every device (ROADMAP queue 2, K3)."""
    return _SddmmAdd.apply(g, sa, sb)
