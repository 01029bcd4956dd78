"""A rank's ELL tables and its local aggregation ops, on the port's
kernels.

Counterpart of ``graphaibench_tpu/parallel/shard_ell.py`` for the 1-D
trainer. A shard's local graph is rectangular: ``nv_pad`` output rows
gather from the extended table (its own rows, then its halo), and it is
not structurally symmetric, so its adjoint needs a table of its own. As
the JAX module does, each rank packs its slot list both ways, a forward
table grouped by local row and a transpose table grouped by extended
column (``ops/device_graph.py::local_table``), and:

  * ``slot_spmm_packed`` runs K1 (``csrc/ell_spmm.cu``) on the forward
    table and its x-adjoint as K1 on the transpose table, on static
    per-slot weights packed per table (GCN, SAGE and GGNN aggregation);
  * ``gat_fused_local_v2`` is the fused GAT attention v2
    (``ops/fused_gat.py``) with the transpose table in its backward's
    transpose role;
  * ``ell_gather_reduce`` and ``ell_gather_reduce_plus``, the pull steps
    of the distributed analytics (``parallel/dist_analytics.py``), are K8
    (``csrc/ell_pull.cu``) on the forward table: a min or a sum over the
    gathered rows, and the min-plus with packed slot weights.

Edge ids are the shard's slot indices [0, e_max), e_max the pad slots'
sentinel, as in the JAX package. Each rank builds and ships only its own
tables: the JAX module stacks every shard's tables on one (R, W) grid
because ``shard_map`` needs identical shapes, which a process per rank
does not. The port does not segment its tables by column (the JAX
package does from 2^18 gathered rows; see ROADMAP's do-not-port list).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graphaibench_tpu_torch.ops.device_graph import (
    DeviceGraph,
    SlotWeights,
    local_table,
    pack_slot_values,
)
from graphaibench_tpu_torch.ops.ell_pull import identity, neighbor_reduce
from graphaibench_tpu_torch.ops.ell_spmm import ell_spmm
from graphaibench_tpu_torch.ops.fused_gat import gat_attention_spmm_v2


@dataclasses.dataclass(frozen=True)
class ShardEll:
    """One rank's tables of one part of its edges: ``fwd`` (rows: local
    rows [0, nv_pad); neighbours: the gathered rows) and ``trans`` (rows:
    the gathered rows; neighbours: local rows), or None where not built.
    ``sentinel`` is the pad slots' edge id (= e_max)."""

    fwd: DeviceGraph
    trans: Optional[DeviceGraph]
    sentinel: int


@dataclasses.dataclass(frozen=True)
class ShardPackedW:
    """Static per-slot weights packed per bucket of ``ShardEll.fwd``
    (``fwd``) and of ``ShardEll.trans`` (``t``)."""

    fwd: SlotWeights
    t: Optional[SlotWeights]


def shard_edges(shard, part: str = "all"):
    """(rows, cols, slot ids) of the rank's real edges in ``part``
    (``shard`` a ``partition.RankShard``): "all" gathers from the
    extended rows (nv_pad + h_max), "own" only the edges from owned rows
    (nv_pad gathered rows), "halo" only those from halo rows, with
    columns shifted by -nv_pad (h_max gathered rows). Returns also the
    gathered rows' count."""
    n_e = int(shard.edge_valid.sum())
    rows = shard.edge_src[:n_e].astype(np.int64)
    cols = shard.col_idx[:n_e].astype(np.int64)
    eids = np.arange(n_e, dtype=np.int64)
    if part == "own":
        sel = cols < shard.nv_pad
        return rows[sel], cols[sel], eids[sel], shard.nv_pad
    if part == "halo":
        sel = cols >= shard.nv_pad
        return rows[sel], cols[sel] - shard.nv_pad, eids[sel], shard.h_max
    if part != "all":
        raise ValueError(f"part must be all, own or halo, not {part!r}")
    return rows, cols, eids, shard.nv_pad + shard.h_max


def build_shard_ell(shard, *, part: str = "all", with_trans: bool = True,
                    device="cpu") -> ShardEll:
    """The rank's tables of ``part`` (see ``shard_edges``) on ``device``:
    the forward table of nv_pad rows over the gathered rows, and with
    ``with_trans`` its transpose (training needs it, a forward-only
    caller does not)."""
    rows, cols, eids, n_gather = shard_edges(shard, part)
    kw = dict(sentinel=shard.e_max, device=device)
    fwd = local_table(rows, cols, eids, n_rows=shard.nv_pad,
                      n_cols=n_gather, **kw)
    trans = (local_table(cols, rows, eids, n_rows=n_gather,
                         n_cols=shard.nv_pad, **kw) if with_trans else None)
    return ShardEll(fwd=fwd, trans=trans, sentinel=shard.e_max)


def build_rank_tables(shard, parts, *, with_trans: bool = True,
                      packed: bool = True, device="cpu") -> dict:
    """{part: (ShardEll, ShardPackedW or None)} of the rank's ``shard``
    for each of ``parts``, with its static slot weights packed per table
    where ``packed``."""
    w = torch.from_numpy(shard.edge_w).to(device) if packed else None
    out = {}
    for p in parts:
        se = build_shard_ell(shard, part=p, with_trans=with_trans,
                             device=device)
        out[p] = (se, None if w is None else pack_shard_values(se, w))
    return out


def pack_shard_values(se: ShardEll, w: torch.Tensor) -> ShardPackedW:
    """The rank's (e_max,) static slot weights ``w`` packed per bucket of
    each table: ``w_pad[b.edge_id]`` for the forward and the transpose
    buckets alike (the transpose is a table of its own, not a
    permutation)."""
    return ShardPackedW(
        fwd=pack_slot_values(se.fwd, w),
        t=None if se.trans is None else pack_slot_values(se.trans, w))


class _SlotSpmmPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, se: ShardEll, wp: ShardPackedW, x):
        ctx.se, ctx.wp = se, wp
        return ell_spmm(se.fwd, wp.fwd, x.contiguous())

    @staticmethod
    def backward(ctx, ct):
        se, wp = ctx.se, ctx.wp
        if se.trans is None:
            raise RuntimeError("slot_spmm_packed: the table was built "
                               "without its transpose, so it has no adjoint")
        return None, None, ell_spmm(se.trans, wp.t, ct.contiguous())


def slot_spmm_packed(n_out: int, se: ShardEll, wp: ShardPackedW,
                     x: torch.Tensor) -> torch.Tensor:
    """out (n_out, F) = the rank's table with static slot weights times x
    (the gathered rows); the x-adjoint is K1 on the transpose table. The
    weights take no gradient. A table without edges gives zeros, and its
    adjoint zeros, with no launch."""
    if n_out != se.fwd.nv:
        raise ValueError(f"n_out {n_out}, the table has {se.fwd.nv} rows")
    return _SlotSpmmPacked.apply(se, wp, x)


def gat_fused_local_v2(n_out: int, se: ShardEll, sl: torch.Tensor,
                       sr_ext: torch.Tensor,
                       h_ext: torch.Tensor) -> torch.Tensor:
    """The rank's fused GAT attention, logits never materialised: sl
    (nv_pad,) row-side scalars, sr_ext and h_ext over the gathered rows.
    Differentiable in all three; the backward's transpose role runs on
    the transpose table."""
    if n_out != se.fwd.nv:
        raise ValueError(f"n_out {n_out}, the table has {se.fwd.nv} rows")
    if se.trans is None:
        raise ValueError("gat_fused_local_v2 needs the transpose table")
    return gat_attention_spmm_v2(se.fwd, sl, sr_ext, h_ext, trans=se.trans)


def _pull(fwd: DeviceGraph, x_ext: torch.Tensor, n_out: int, kind: str,
          sentinel: int, packed=None) -> torch.Tensor:
    if n_out != fwd.nv:
        raise ValueError(f"n_out {n_out}, the table has {fwd.nv} rows")
    if sentinel != fwd.ne:
        raise ValueError(f"sentinel {sentinel}, the table's pad slots are "
                         f"{fwd.ne}")
    if not fwd.has_ell_layout:      # a rank without edges: no launch
        if x_ext.shape != (fwd.n_cols,):
            raise ValueError(f"x_ext of shape {tuple(x_ext.shape)}, the "
                             f"table gathers from {fwd.n_cols} rows")
        return x_ext.new_full((n_out,), identity(kind, x_ext.dtype))
    return neighbor_reduce(fwd, x_ext, kind, packed)


def ell_gather_reduce(fwd: DeviceGraph, x_ext: torch.Tensor, n_out: int,
                      kind: str, sentinel: int) -> torch.Tensor:
    """out (n_out,) [r] = reduce over the rank's edges (r -> c) of
    x_ext[c]: K8 on the forward table ``fwd`` (n_out rows over the
    gathered rows of the 1-D ``x_ext``, int32 or float32), ``kind`` min,
    max or sum. Pad slots (edge id ``sentinel``) and rows without edges
    give the identity: the int32 extremes, +-inf, 0. JAX's float min
    starts from the largest finite float where K8 starts from +inf; no
    caller of either package takes a float min without edge values."""
    return _pull(fwd, x_ext, n_out, kind, sentinel)


def ell_gather_reduce_plus(fwd: DeviceGraph, packed, x_ext: torch.Tensor,
                           n_out: int, kind: str,
                           sentinel: int) -> torch.Tensor:
    """out (n_out,) [r] = reduce over the rank's edges (r -> c) of
    x_ext[c] + w(slot): the min-plus (or max-plus) pull behind the
    distributed SSSP, K8 with edge values. ``packed`` are the float32 slot
    weights packed per bucket of ``fwd`` (``pack_shard_values(se, w).fwd``,
    packed once a solve); ``x_ext`` float32."""
    if kind not in ("min", "max"):
        raise ValueError(f"ell_gather_reduce_plus takes min or max, not "
                         f"{kind!r}")
    return _pull(fwd, x_ext, n_out, kind, sentinel, packed)
