"""Bucket passes over per-edge values: three hand-written CUDA kernels
(``csrc/ell_edge.cu``) with their plain PyTorch versions.

Counterparts of XLA programs of the JAX package that sweep the ELL
buckets with (ne,) arrays read through the slots' edge ids:

    ell_row_reduce  ``ops/segment.py::_row_reduce_ell`` and
                    ``ops/fused_gat.py::_row_denom_ell``: per row i over its
                    edges e, ``max`` v_e, ``sum`` v_e or ``sumexp``
                    sum_e exp(v_e - m_i)
    gat_v1_fwd      ``ops/fused_gat.py::_fused_fwd_pass``:
                    out_i = sum_j exp(l_e - m_i) zinv_i w_e x[nbr_j],
                    e the edge of slot j — the fused GAT attention on
                    per-edge logits and per-edge weights or masks
    sddmm_dot_ell   ``ops/spmm.py::sddmm_dot``: raw_e = <a[src_e], b[dst_e]>

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, or raises; ``LAUNCHES`` counts
the launches per kernel. A row of degree > 64 is several virtual rows: the
kernels store the rows that have one and combine (atomic add, atomic max)
the pieces of split rows into outputs whose ``g.zero_rows`` the wrapper
initialised.

Bytes bound all three (0.5 flop per gathered byte in the wide passes, no
reuse across pairs, hence no tensor cores); the two wide passes run at the
time of the SpMM's gather of the same rows. ``gat_v1_fwd`` does a slot's
scalar work (ids, weight, logit, one exp) in one lane and hands id and
coefficient to the row's other lanes by shuffles; asked to, it also writes
the row softmax of the logits it has in hand, which the v1 backward reads
instead of computing it again. Its feature tile follows a rule of its own
(``_v1_tile_floats``). ``sddmm_dot_ell`` gives a row at most 16 lanes, adds
the lanes' partial dot products of 8 slots by a transposing butterfly that
leaves each slot's total in another lane, and stores them together; every
edge sits in exactly one slot, so each element of its output is written
once, by a plain store. The source's note has the measurements.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import (
    _check,
    _empty_but,
    _launch_tail,
    _raise_on,
    _table,
    _wide_shape,
)
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph

LAUNCHES = {"ell_row_reduce": 0, "gat_v1_fwd": 0, "sddmm_dot_ell": 0}

KINDS = {"max": 0, "sum": 1, "sumexp": 2}     # the kernel's `kind` argument


def _v1_tile_floats(nv: int, f: int) -> int:
    """Feature columns per tile of gat_v1_fwd's float4 instantiation: one
    float4 per lane of a warp, whatever the graph's size. Every tile
    prepares the slots again (ids, weight, logit, exp), and with that work
    done once per slot the gather's locality no longer pays for a second
    tile: measured on an H100 at F = 128 (device times of
    tools/gat_kernels_probe.py), 128 floats take 0.289 ms at 2^17 vertices
    where 64 take 0.298 and 32 take 0.332; at 2^19 vertices 1.548, 1.547
    and 1.749 ms, and 1.618 against 1.632 with the scores written."""
    return min(f, 128)


# ---- plain PyTorch versions ------------------------------------------------

def _views(b):
    """(row ids (R,), neighbour ids (R, W), edge ids (R, W)) of a bucket;
    a pad slot's edge id is ne."""
    return (b.row_ids.long(), b.nbr.view(b.rows, b.width).long(),
            b.edge_id.view(b.rows, b.width).long())


def ell_row_reduce_plain(g: DeviceGraph, vals: torch.Tensor, kind: str,
                         m: torch.Tensor | None = None) -> torch.Tensor:
    neg_inf = float("-inf")
    # the pad slots read one value past the edges: the reduction's identity
    # (exp(-inf - m) = 0 for "sumexp")
    v_pad = torch.cat([vals, vals.new_full((1,), 0.0 if kind == "sum" else neg_inf)])
    out = vals.new_full((g.nv,), neg_inf if kind == "max" else 0.0)
    for b in g.ell:
        rows, _, eid = _views(b)
        vb = v_pad[eid]
        if kind == "max":
            out.scatter_reduce_(0, rows, vb.amax(1), "amax")
        elif kind == "sum":
            out.index_add_(0, rows, vb.sum(1))
        else:
            out.index_add_(0, rows, torch.exp(vb - m[rows][:, None]).sum(1))
    return out


def gat_v1_fwd_plain(g: DeviceGraph, logits, edge_w, x, m, zinv,
                     with_scores: bool = False):
    l_pad = torch.cat([logits, logits.new_full((1,), float("-inf"))])
    w_pad = torch.cat([edge_w, edge_w.new_zeros(1)])
    out = x.new_zeros((g.nv, x.shape[1]))
    # NaN where no slot writes: every edge must have one
    scores = logits.new_full((g.ne,), float("nan")) if with_scores else None
    for b in g.ell:
        rows, nbr, eid = _views(b)
        w = w_pad[eid]
        p = torch.exp(l_pad[eid] - m[rows][:, None]) * zinv[rows][:, None]
        s = torch.where(w == 0, torch.zeros_like(p), p * w)   # a mask gives exact 0
        out.index_add_(0, rows, (s[:, :, None] * x[nbr]).sum(1))
        if with_scores:
            real = eid != g.ne
            scores[eid[real]] = p[real]
    return (out, scores) if with_scores else out


def sddmm_dot_ell_plain(g: DeviceGraph, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    # NaN where no slot writes: every edge must have one
    raw = a.new_full((g.ne,), float("nan"))
    for bk in g.ell:
        rows, nbr, eid = _views(bk)
        d = (a[rows][:, None, :] * b[nbr]).sum(-1)
        real = eid != g.ne
        raw[eid[real]] = d[real]
    return raw


# ---- the kernels' wrappers -------------------------------------------------

def ell_row_reduce(g: DeviceGraph, vals: torch.Tensor, kind: str,
                   m: torch.Tensor | None = None) -> torch.Tensor:
    """Per-source-row reduction of (ne,) per-edge values over the ELL
    buckets: ``"max"`` (-inf for an edgeless row), ``"sum"``, or
    ``"sumexp"``, sum_e exp(v_e - m_i) for a per-row shift ``m`` (nv,)
    (both 0 for an edgeless row)."""
    if kind not in KINDS:
        raise ValueError(f"unknown reduction {kind!r}")
    if (m is not None) != (kind == "sumexp"):
        raise ValueError('the row shift m goes with kind "sumexp" and no other')
    dev = _check(g, vectors=() if m is None else (m,), edges=(vals,))
    if dev.type == "cpu":
        return ell_row_reduce_plain(g, vals, kind, m)
    table = _table(g)
    lib = _build.load_library("ell_edge")
    out = _empty_but(g, vals, (g.nv,), float("-inf") if kind == "max" else 0.0)
    rc = lib.gab_ell_row_reduce(
        *table.args, vals.data_ptr(), None if m is None else m.data_ptr(),
        out.data_ptr(), KINDS[kind], *_launch_tail(vals))
    _raise_on(rc, lib, "ell_row_reduce", f"kind {kind}")
    LAUNCHES["ell_row_reduce"] += 1
    return out


def gat_v1_fwd(g: DeviceGraph, logits, edge_w, x, m, zinv,
               with_scores: bool = False):
    """out_i = sum over i's edges e = (i, j) of
    exp(logits_e - m_i) zinv_i edge_w_e x_j, for the row max ``m`` and the
    inverse softmax denominator ``zinv`` of the logits. With
    ``with_scores`` the pair (out, scores): scores_e = exp(logits_e - m_i)
    zinv_i, (ne,), the softmax of the logits over each row, which the pass
    has in hand and a backward would compute again."""
    dev = _check(g, vectors=(m, zinv), matrices=(x,), edges=(logits, edge_w))
    if dev.type == "cpu":
        return gat_v1_fwd_plain(g, logits, edge_w, x, m, zinv, with_scores)
    f = x.shape[1]
    if f == 0:
        raise ValueError("x has no columns")
    table = _table(g)
    lib = _build.load_library("ell_edge")
    out = _empty_but(g, x, (g.nv, f), 0.0)
    scores = torch.empty_like(logits) if with_scores else None
    tile_v, vec, _ = _wide_shape(g.nv, f, x, out,
                                 tile_floats=_v1_tile_floats)
    rc = lib.gab_gat_v1_fwd(
        *table.args, logits.data_ptr(), edge_w.data_ptr(), m.data_ptr(),
        zinv.data_ptr(), x.data_ptr(), out.data_ptr(),
        scores.data_ptr() if with_scores else None, f, tile_v, vec,
        *_launch_tail(x))
    _raise_on(rc, lib, "gat_v1_fwd", f"F={f}, tile_v={tile_v}, vec={vec}")
    LAUNCHES["gat_v1_fwd"] += 1
    return (out, scores) if with_scores else out


def sddmm_dot_ell(g: DeviceGraph, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """raw_e = <a[src_e], b[dst_e]> for every edge, (ne,)."""
    dev = _check(g, matrices=(a, b))
    if dev.type == "cpu":
        return sddmm_dot_ell_plain(g, a, b)
    f = a.shape[1]
    if f == 0:
        raise ValueError("a and b have no columns")
    table = _table(g)
    lib = _build.load_library("ell_edge")
    raw = torch.empty(g.ne, dtype=a.dtype, device=a.device)
    vec = int(f % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    # the table's last entry is is_split, which this pass does not take:
    # each edge is written by one slot
    rc = lib.gab_sddmm_dot_ell(*table.args[:-1], a.data_ptr(), b.data_ptr(),
                               raw.data_ptr(), f, vec, *_launch_tail(a))
    _raise_on(rc, lib, "sddmm_dot_ell", f"F={f}, vec={vec}")
    LAUNCHES["sddmm_dot_ell"] += 1
    return raw
