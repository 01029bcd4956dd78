"""Segment ops over CSR rows: softmax over each vertex's edge list.

Counterpart of ``graphaibench_tpu/ops/segment.py``: the GAT attention
normalization (gat_aggregator.cpp:78-80, softmax over a vertex's outgoing
edges) and its exact derivative (gat_aggregator.cpp:132-153) as
edge-parallel segment ops. The JAX package streams its row reductions
through the ELL buckets; on a CUDA graph with ELL buckets the port does
too, through the kernel ``ell_row_reduce`` (``ops/ell_edge.py``). On the
CPU, and on a graph without buckets (the padded subgraphs of sampled
training), a row reduction is one ``index_add_`` / ``scatter_reduce_``
over ``edge_src``. ``neighbor_reduce`` (the analytics pull primitive) is
ROADMAP queue 1, P12.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.ell_edge import ell_row_reduce


class _RowSumEll(torch.autograd.Function):
    """The kernel's row sum with its adjoint, a gather by edge source."""

    @staticmethod
    def forward(ctx, g: DeviceGraph, vals):
        ctx.g = g
        return ell_row_reduce(g, vals.contiguous(), "sum")

    @staticmethod
    def backward(ctx, ct):
        return None, ct[ctx.g.edge_src]


def _row_reduce_ell(g: DeviceGraph, vals: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-source-row reduction of (ne,) per-edge values: ``"sum"`` (0 for
    an edgeless row) or ``"max"`` (-inf for an edgeless row, and no
    gradient: its callers shift by it)."""
    if kind not in ("sum", "max"):
        raise ValueError(f"unknown reduction {kind!r}")
    if vals.is_cuda and g.has_ell_layout:
        if kind == "sum":
            return _RowSumEll.apply(g, vals)
        return ell_row_reduce(g, vals.detach().contiguous(), "max")
    if kind == "sum":
        return vals.new_zeros(g.nv).index_add_(0, g.edge_src, vals)
    out = vals.new_full((g.nv,), float("-inf"))
    return out.scatter_reduce_(0, g.edge_src.long(), vals, "amax")


def segment_sum_edges(g: DeviceGraph, vals: torch.Tensor) -> torch.Tensor:
    return _row_reduce_ell(g, vals, "sum")


def segment_softmax(g: DeviceGraph, scores: torch.Tensor) -> torch.Tensor:
    """Row-wise (per-source-vertex) softmax of per-edge scores:
    max-subtracted exp, normalized within the row. The max shift carries
    no gradient (softmax is shift-invariant)."""
    seg = g.edge_src
    row_max = _row_reduce_ell(g, scores.detach(), "max")
    e = torch.exp(scores - row_max[seg])
    return e / _row_reduce_ell(g, e, "sum")[seg]


def segment_softmax_vjp(g: DeviceGraph, y: torch.Tensor,
                        dy: torch.Tensor) -> torch.Tensor:
    """Adjoint of segment_softmax given outputs y and cotangent dy:
    dx_e = y_e * (dy_e - sum_row(y*dy))."""
    inner = _row_reduce_ell(g, y * dy, "sum")
    return y * (dy - inner[g.edge_src])
