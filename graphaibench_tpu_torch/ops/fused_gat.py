"""Fused GAT attention: softmax over each vertex's edges and the
score-weighted aggregation in one op, in two versions.

v2, counterpart of ``graphaibench_tpu/ops/fused_gat.py::gat_attention_spmm_v2``,
works without any per-edge array. For all-ones edge weights on a
structurally symmetric graph,

    out_i = sum_j softmax_j(leaky(sl_i + sr_j)) h_j      (j over i's edges)

rests on three facts (see the JAX module): the logits are rank-1, so they
are recomputed per slot from two per-vertex scalars; LeakyReLU is
monotone, so the row max of the logits is ``leaky(sl_i + max_j sr_j)``;
and the softmax adjoint's row term ``sum_j p_ij <ct_i, h_j>`` equals
``<ct_i, out_i>``, elementwise from the saved output.

Bucket passes do the work, each a hand-written CUDA kernel in
``csrc/fused_gat.cu`` with its plain PyTorch version here:

    gat_rowmax     m0_i = max_j sr_j                       (-inf: no edges)
    gat_v2_fwd     e_ij = exp(leaky(sl_i + sr_j) - m_i);
                   acc_i = sum_j e_ij h_j;  z_i = sum_j e_ij
    gat_v2_bwd_sl  p = e_ij zinv_i;
                   d_sl_i = sum_j p (<ct_i, h_j> - inner_i) leaky'
    gat_v2_bwd_h   transpose role, same buckets: for row j over its
                   neighbours i, p = exp(leaky(sl_i + sr_j) - m_i) zinv_i;
                   d_h_j = sum_i p ct_i;
                   t_ij = p (<h_j, ct_i> - inner_i) leaky';
                   d_sr_j = sum_i t_ij
    gat_v2_bwd     gat_v2_bwd_h, which also adds every t_ij into d_sl_i:
                   the whole backward with one gather

The backward that wants all three gradients takes the single pass where
the gathered matrix is large enough for the gather to hide its atomics
(``_single_pass``), else the two passes; a caller that wants ``d_sl``
alone, or no ``d_sl``, gets the one pass it needs.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, or raises; ``LAUNCHES`` counts
the launches per kernel. A row of degree > 64 is several virtual rows, so
no pass completes a row by itself: the kernels store the rows that have
one virtual row and combine (atomic add, atomic max) the pieces of split
rows into outputs whose ``g.zero_rows`` the wrapper initialised. That is
why the forward is two launches with the normalisation after them.

The JAX package gathers in bf16 from 2^17 vertices on, chunks the packed
columns and stages its buckets; those are answers to its device's gather
engine and memory and are not carried over: the port gathers float32 at
every size, so at nv >= 2^17 the two packages differ by bf16 rounding of
the gathered operands on the JAX side.

v1, counterpart of ``gat_attention_spmm`` of the same JAX module, takes
(ne,) logits and (ne,) edge weights or masks, which v2 cannot:

    out_i = sum_e softmax_row(logits)_e edge_w_e x_j      (e = (i, j))

Its forward is three bucket passes of ``ops/ell_edge.py`` (row max, row
sum of exp, the weighted aggregation ``gat_v1_fwd``): the normalizers are
indexed per row inside the passes. The backward affords one materialized
score vector, as the JAX module's does; where a backward can follow, the
forward pass, which has every score in hand, writes it, and it is saved
in place of the logits and the normalizers (an evaluation writes none).
The backward runs the ELL SpMM (K1) on the transpose-permuted scores for
``dx``, ``sddmm_dot_ell`` for the per-edge <ct_i, x_j> and a row sum for
the softmax adjoint. ``apply_model`` reaches it for GAT on an ELL graph
unless the caller promises all-ones weights (``trivial_w``).
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops import _build, _ell_launch
from graphaibench_tpu_torch.ops._ell_launch import (
    _check,
    _empty_but,
    _launch_tail,
    _raise_on,
    _table,
    _wide_shape,
)
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.ell_edge import ell_row_reduce, gat_v1_fwd
from graphaibench_tpu_torch.ops.segment import _row_reduce_ell
from graphaibench_tpu_torch.ops.spmm import sddmm_dot, spmm_ell

LAUNCHES = {"gat_rowmax": 0, "gat_v2_fwd": 0, "gat_v2_bwd_sl": 0,
            "gat_v2_bwd_h": 0, "gat_v2_bwd": 0}

SLOPE = 0.2
# Floor of the softmax denominator: a NORMAL float32 (1e-38 is subnormal
# and a flush-to-zero mode would turn an edgeless row's 1/z into inf).
Z_FLOOR = 1e-30


def _leaky(raw: torch.Tensor) -> torch.Tensor:
    return torch.where(raw > 0, raw, SLOPE * raw)


def _leaky_grad(raw: torch.Tensor) -> torch.Tensor:
    return torch.where(raw > 0, 1.0, SLOPE)


# ---- plain PyTorch versions ------------------------------------------------

def _views(g: DeviceGraph, b):
    """(row ids (R,), neighbour ids (R, W), pad mask (R, W)) of a bucket."""
    return (b.row_ids.long(), b.nbr.view(b.rows, b.width).long(),
            b.edge_id.view(b.rows, b.width) == g.ne)


def gat_rowmax_plain(g: DeviceGraph, sr: torch.Tensor) -> torch.Tensor:
    out = sr.new_full((g.nv,), float("-inf"))
    for b in g.ell:
        rows, nbr, pad = _views(g, b)
        vb = sr[nbr].masked_fill(pad, float("-inf")).amax(1)
        out.scatter_reduce_(0, rows, vb, "amax")
    return out


def gat_v2_fwd_plain(g: DeviceGraph, sl, sr, m, h):
    acc = h.new_zeros((g.nv, h.shape[1]))
    z = h.new_zeros(g.nv)
    for b in g.ell:
        rows, nbr, pad = _views(g, b)
        raw = sl[rows][:, None] + sr[nbr]
        e = torch.exp(_leaky(raw) - m[rows][:, None]).masked_fill(pad, 0.0)
        acc.index_add_(0, rows, (e[:, :, None] * h[nbr]).sum(1))
        z.index_add_(0, rows, e.sum(1))
    return acc, z


def gat_v2_bwd_sl_plain(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    d_sl = sl.new_zeros(g.nv)
    for b in g.ell:
        rows, nbr, pad = _views(g, b)
        raw = sl[rows][:, None] + sr[nbr]
        p = (torch.exp(_leaky(raw) - m[rows][:, None])
             * zinv[rows][:, None]).masked_fill(pad, 0.0)
        dsw = (ct[rows][:, None, :] * h[nbr]).sum(-1)
        dlraw = p * (dsw - inner[rows][:, None]) * _leaky_grad(raw)
        d_sl.index_add_(0, rows, dlraw.sum(1))
    return d_sl


def gat_v2_bwd_h_plain(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    d_h = h.new_zeros((g.nv, h.shape[1]))
    d_sr = sr.new_zeros(g.nv)
    for b in g.ell:
        rows, nbr, pad = _views(g, b)
        raw = sl[nbr] + sr[rows][:, None]              # sl_i + sr_j
        p = (torch.exp(_leaky(raw) - m[nbr]) * zinv[nbr]).masked_fill(pad, 0.0)
        ctg = ct[nbr]
        dsw = (h[rows][:, None, :] * ctg).sum(-1)
        dlraw = p * (dsw - inner[nbr]) * _leaky_grad(raw)
        d_h.index_add_(0, rows, (p[:, :, None] * ctg).sum(1))
        d_sr.index_add_(0, rows, dlraw.sum(1))
    return d_h, d_sr


def gat_v2_bwd_plain(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    """(d_sl, d_sr, d_h) from the transpose role alone: d_sl sums the
    per-slot terms by neighbour, which needs the structural symmetry."""
    d_h = h.new_zeros((g.nv, h.shape[1]))
    d_sl = sl.new_zeros(g.nv)
    d_sr = sr.new_zeros(g.nv)
    for b in g.ell:
        rows, nbr, pad = _views(g, b)
        raw = sl[nbr] + sr[rows][:, None]              # sl_i + sr_j
        p = (torch.exp(_leaky(raw) - m[nbr]) * zinv[nbr]).masked_fill(pad, 0.0)
        ctg = ct[nbr]
        dsw = (h[rows][:, None, :] * ctg).sum(-1)
        t = p * (dsw - inner[nbr]) * _leaky_grad(raw)
        d_h.index_add_(0, rows, (p[:, :, None] * ctg).sum(1))
        d_sr.index_add_(0, rows, t.sum(1))
        d_sl.index_add_(0, nbr.reshape(-1), t.reshape(-1))
    return d_sl, d_sr, d_h


# ---- the kernels' wrappers -------------------------------------------------

def _check_int4_ids(g: DeviceGraph) -> None:
    """gat_rowmax reads a row's neighbour ids as int4 (``_ell_launch``)."""
    _ell_launch._check_int4_ids(g, "gat_rowmax")


def gat_rowmax(g: DeviceGraph, sr: torch.Tensor) -> torch.Tensor:
    """m0_i = max over i's edges of sr_j; -inf for an edgeless row."""
    if _check(g, vectors=(sr,)).type == "cpu":
        return gat_rowmax_plain(g, sr)
    table = _table(g)
    _check_int4_ids(g)
    lib = _build.load_library("fused_gat")
    m0 = _empty_but(g, sr, (g.nv,), float("-inf"))
    rc = lib.gab_gat_rowmax(*table.args, sr.data_ptr(), m0.data_ptr(),
                            *_launch_tail(sr))
    _raise_on(rc, lib, "gat_rowmax", f"{table.args[6]} buckets")
    LAUNCHES["gat_rowmax"] += 1
    return m0


def _fwd_tile_floats(nv: int, f: int) -> int:
    """Feature columns per tile of the forward pass's float4
    instantiation: 64, whatever the graph's size, though every further
    tile repeats each slot's id read, ``sr`` gather and exp. Measured on
    an H100 at F = 128 (device times of tools/gat_kernels_probe.py): 64
    floats against 128 take 0.0581 against 0.0595 ms at 2^15 vertices,
    0.1271 against 0.1260 at 2^16, 0.2711 against 0.2712 at 2^17 and
    1.3040 against 1.3855 at 2^19; 32 floats 0.2865 and 1.3579. One tile
    of 128 wins only at 2^13 vertices, 0.0144 against 0.0150."""
    return min(f, 64)


def gat_v2_fwd(g: DeviceGraph, sl, sr, m, h):
    """(acc, z): the unnormalised aggregation and the softmax
    denominator, for the row max ``m`` of the logits."""
    if _check(g, vectors=(sl, sr, m), matrices=(h,)).type == "cpu":
        return gat_v2_fwd_plain(g, sl, sr, m, h)
    f = h.shape[1]
    if f == 0:
        raise ValueError("h has no columns")
    table = _table(g)
    lib = _build.load_library("fused_gat")
    acc = _empty_but(g, h, (g.nv, f), 0.0)
    z = _empty_but(g, h, (g.nv,), 0.0)
    tile_v, vec, _ = _wide_shape(g.nv, f, h, acc,
                                 tile_floats=_fwd_tile_floats)
    rc = lib.gab_gat_v2_fwd(*table.args, sl.data_ptr(), sr.data_ptr(),
                            m.data_ptr(), h.data_ptr(), acc.data_ptr(),
                            z.data_ptr(), f, tile_v, vec, *_launch_tail(h))
    _raise_on(rc, lib, "gat_v2_fwd", f"F={f}, tile_v={tile_v}, vec={vec}")
    LAUNCHES["gat_v2_fwd"] += 1
    return acc, z


def _bwd_tile_floats(nv: int, f: int) -> int:
    """Feature columns per tile of the backward passes' float4
    instantiation: one tile of up to 128 floats, whatever the graph's
    size. A second tile repeats every slot's scalar work and turns the
    per-row sums into atomics: measured on an H100 at F = 128 (device
    times of tools/gat_kernels_probe.py), 128 floats against 64 take
    0.341 against 0.376 ms (gat_v2_bwd_h), 0.354 against 0.411
    (gat_v2_bwd) and 0.284 against 0.291 (gat_v2_bwd_sl) at 2^17
    vertices; at 2^19 vertices 1.783 against 1.811, 1.892 against 1.974
    and 1.409 against 1.381."""
    return min(f, 128)


def _single_pass(nv: int, f: int) -> bool:
    """Whether the backward that wants all three gradients takes one pass
    (``gat_v2_bwd``) or two (``gat_v2_bwd_sl``, ``gat_v2_bwd_h``). One
    pass gathers once but adds an atomic per slot, which only a long
    gather hides: measured on an H100 (device times of
    tools/gat_kernels_probe.py) it wins from a 16 MiB matrix on - at 2^17
    vertices 0.139 ms against 0.180 at F = 32 and 0.352 against 0.625 at
    F = 128, at 2^19 vertices 0.524 against 0.561 at F = 8 - and loses
    below: at 2^17 vertices 0.143 against 0.123 at F = 16."""
    return nv * f * 4 >= 16 << 20


def gat_v2_bwd_sl(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    """d_sl of the fused attention (pass B1)."""
    dev = _check(g, vectors=(sl, sr, m, zinv, inner), matrices=(h, ct))
    if dev.type == "cpu":
        return gat_v2_bwd_sl_plain(g, sl, sr, m, zinv, inner, h, ct)
    f = h.shape[1]
    if f == 0:
        raise ValueError("h has no columns")
    table = _table(g)
    lib = _build.load_library("fused_gat")
    tile_v, vec, tiles = _wide_shape(g.nv, f, h, ct,
                                     tile_floats=_bwd_tile_floats)
    # several tiles add their parts of a row's sum: then every row starts at 0
    d_sl = (sl.new_zeros(g.nv) if tiles > 1
            else _empty_but(g, sl, (g.nv,), 0.0))
    rc = lib.gab_gat_v2_bwd_sl(
        *table.args, sl.data_ptr(), sr.data_ptr(), m.data_ptr(),
        zinv.data_ptr(), inner.data_ptr(), h.data_ptr(), ct.data_ptr(),
        d_sl.data_ptr(), f, tile_v, vec, *_launch_tail(h))
    _raise_on(rc, lib, "gat_v2_bwd_sl", f"F={f}, tile_v={tile_v}, vec={vec}")
    LAUNCHES["gat_v2_bwd_sl"] += 1
    return d_sl


def _bwd_h_launch(g: DeviceGraph, name, sl, sr, m, zinv, inner, h, ct,
                  with_sl: bool):
    """(d_h, d_sr, d_sl or None) by the transpose-role kernel, counted
    under ``name``."""
    f = h.shape[1]
    if f == 0:
        raise ValueError("h has no columns")
    table = _table(g)
    lib = _build.load_library("fused_gat")
    # what the pass reads of a neighbour besides its row of ct, as one
    # 16-byte row per vertex
    pack = torch.stack([sl, m, zinv, inner], dim=1)
    d_h = _empty_but(g, h, (g.nv, f), 0.0)
    tile_v, vec, tiles = _wide_shape(g.nv, f, h, ct, d_h,
                                     tile_floats=_bwd_tile_floats)
    d_sr = (sr.new_zeros(g.nv) if tiles > 1
            else _empty_but(g, sr, (g.nv,), 0.0))
    # every slot adds its term to its neighbour's d_sl
    d_sl = sl.new_zeros(g.nv) if with_sl else None
    rc = lib.gab_gat_v2_bwd_h(
        *table.args, pack.data_ptr(), sr.data_ptr(), h.data_ptr(),
        ct.data_ptr(), d_h.data_ptr(), d_sr.data_ptr(),
        d_sl.data_ptr() if with_sl else None, f, tile_v, vec,
        *_launch_tail(h))
    _raise_on(rc, lib, name, f"F={f}, tile_v={tile_v}, vec={vec}")
    LAUNCHES[name] += 1
    return d_h, d_sr, d_sl


def gat_v2_bwd_h(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    """(d_h, d_sr) of the fused attention (pass B2, transpose role)."""
    dev = _check(g, vectors=(sl, sr, m, zinv, inner), matrices=(h, ct))
    if dev.type == "cpu":
        return gat_v2_bwd_h_plain(g, sl, sr, m, zinv, inner, h, ct)
    return _bwd_h_launch(g, "gat_v2_bwd_h", sl, sr, m, zinv, inner, h, ct,
                         False)[:2]


def gat_v2_bwd(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    """(d_sl, d_sr, d_h) of the fused attention with one gather: the
    transpose-role pass has every t_ij = p_ij leaky'_ij (<ct_i, h_j> -
    inner_i) in hand, d_sr_j is its sum over the row and d_sl_i its sum
    by neighbour, which the pass adds with one atomic per slot."""
    dev = _check(g, vectors=(sl, sr, m, zinv, inner), matrices=(h, ct))
    if dev.type == "cpu":
        return gat_v2_bwd_plain(g, sl, sr, m, zinv, inner, h, ct)
    d_h, d_sr, d_sl = _bwd_h_launch(g, "gat_v2_bwd", sl, sr, m, zinv, inner,
                                    h, ct, True)
    return d_sl, d_sr, d_h


# ---- the differentiable op -------------------------------------------------

def _v2_forward(g: DeviceGraph, sl, sr, h):
    """(out, m, zinv) — ``_v2_fwd`` of the JAX module."""
    m0 = gat_rowmax(g, sr)
    m0 = torch.where(torch.isfinite(m0), m0, torch.zeros_like(m0))
    m = _leaky(sl + m0)                  # the exact row max of the logits
    acc, z = gat_v2_fwd(g, sl, sr, m, h)
    zinv = 1.0 / torch.clamp(z, min=Z_FLOOR)
    return acc.mul_(zinv[:, None]), m, zinv


class _GatV2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: DeviceGraph, sl, sr, h):
        sl, sr, h = sl.contiguous(), sr.contiguous(), h.contiguous()
        out, m, zinv = _v2_forward(g, sl, sr, h)
        ctx.g = g
        ctx.save_for_backward(sl, sr, h, m, zinv, out)
        return out

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        sl, sr, h, m, zinv, out = ctx.saved_tensors
        ct = ct.contiguous()
        # softmax-adjoint row term: sum_j p_j <ct_i, h_j> = <ct_i, out_i>
        inner = (ct * out).sum(1)
        args = (g, sl, sr, m, zinv, inner, h, ct)
        d_sl = d_sr = d_h = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            if not ctx.needs_input_grad[1]:
                d_h, d_sr = gat_v2_bwd_h(*args)
            elif _single_pass(g.nv, h.shape[1]):
                d_sl, d_sr, d_h = gat_v2_bwd(*args)
            else:
                d_sl = gat_v2_bwd_sl(*args)
                d_h, d_sr = gat_v2_bwd_h(*args)
        elif ctx.needs_input_grad[1]:
            d_sl = gat_v2_bwd_sl(*args)
        return None, d_sl, d_sr, d_h


def gat_attention_spmm_v2(g: DeviceGraph, sl: torch.Tensor, sr: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    """out = softmax-weighted aggregation with logits
    leaky_relu(sl[src] + sr[dst]) computed inside the bucket passes.
    Requires all-ones edge weights and a structurally symmetric graph —
    the full-batch GAT case (gat_aggregator.cpp:57-102 semantics)."""
    return _GatV2.apply(g, sl, sr, h)


# ---- v1: per-edge logits and weights ---------------------------------------

def _norm_consts(g: DeviceGraph, logits: torch.Tensor):
    """(m, zinv): the row max of the logits (0 for an edgeless row) and
    the inverse softmax denominator, floored like v2's."""
    m = ell_row_reduce(g, logits, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = ell_row_reduce(g, logits, "sumexp", m)
    return m, 1.0 / torch.clamp(z, min=Z_FLOOR)


class _GatV1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g: DeviceGraph, logits, edge_w, x, differentiated: bool):
        logits, edge_w, x = logits.contiguous(), edge_w.contiguous(), x.contiguous()
        m, zinv = _norm_consts(g, logits)
        if not differentiated:
            return gat_v1_fwd(g, logits, edge_w, x, m, zinv)
        # the backward affords one materialized score vector; the forward
        # pass has it in hand and writes it once
        out, s_soft = gat_v1_fwd(g, logits, edge_w, x, m, zinv, True)
        ctx.g = g
        ctx.save_for_backward(edge_w, x, s_soft)
        return out

    @staticmethod
    def backward(ctx, ct):
        edge_w, x, s_soft = ctx.saved_tensors
        return (None, *_v1_backward(ctx.g, ct.contiguous(), edge_w, x, s_soft,
                                    ctx.needs_input_grad[1:4]), None)


def _v1_backward(g: DeviceGraph, ct, edge_w, x, s_soft, needs):
    """(d_logits, d_edge_w, d_x) of v1, each None where ``needs`` says so,
    from the row softmax ``s_soft`` of the logits."""
    need_l, need_w, need_x = needs
    dl = dew = dx = None
    if need_x:
        # adjoint aggregation: same topology, transpose-permuted scores
        dx = spmm_ell(g, (s_soft * edge_w)[g.trans_perm], ct)
    if need_l or need_w:
        # per-edge <ct[src], x[dst]> feeds the edge_w cotangent and
        # the softmax adjoint, as on the unfused path
        raw = sddmm_dot(g, ct, x)
        if need_w:
            dew = s_soft * raw
        if need_l:
            dsw = raw * edge_w
            inner = _row_reduce_ell(g, s_soft * dsw, "sum")
            dl = s_soft * (dsw - inner[g.edge_src])
    return dl, dew, dx


def gat_attention_spmm(g: DeviceGraph, logits: torch.Tensor,
                       edge_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out = A(softmax_row(logits) * edge_w) @ x, fused over the ELL
    buckets; differentiable in ``logits``, ``edge_w`` and ``x`` (edge_w's
    cotangent is softmax(logits) * <ct[src], x[dst]>, as on the unfused
    path). ``g`` must have ELL buckets and be structurally symmetric."""
    # inside the Function grad mode is off and needs_input_grad ignores it:
    # whether a backward can follow is settled here
    differentiated = torch.is_grad_enabled() and any(
        t.requires_grad for t in (logits, edge_w, x))
    return _GatV1.apply(g, logits, edge_w, x, differentiated)
