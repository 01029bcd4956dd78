"""Fused GAT attention (v2): softmax over each vertex's edges and the
score-weighted aggregation without a per-edge array.

Counterpart of ``graphaibench_tpu/ops/fused_gat.py::gat_attention_spmm_v2``.
For all-ones edge weights on a structurally symmetric graph,

    out_i = sum_j softmax_j(leaky(sl_i + sr_j)) h_j      (j over i's edges)

rests on three facts (see the JAX module): the logits are rank-1, so they
are recomputed per slot from two per-vertex scalars; LeakyReLU is
monotone, so the row max of the logits is ``leaky(sl_i + max_j sr_j)``;
and the softmax adjoint's row term ``sum_j p_ij <ct_i, h_j>`` equals
``<ct_i, out_i>``, elementwise from the saved output.

Four bucket passes do the work, each a hand-written CUDA kernel in
``csrc/fused_gat.cu`` with its plain PyTorch version here:

    gat_rowmax     m0_i = max_j sr_j                       (-inf: no edges)
    gat_v2_fwd     e_ij = exp(leaky(sl_i + sr_j) - m_i);
                   acc_i = sum_j e_ij h_j;  z_i = sum_j e_ij
    gat_v2_bwd_sl  p = e_ij zinv_i;
                   d_sl_i = sum_j p (<ct_i, h_j> - inner_i) leaky'
    gat_v2_bwd_h   transpose role, same buckets: for row j over its
                   neighbours i, p = exp(leaky(sl_i + sr_j) - m_i) zinv_i;
                   d_h_j = sum_i p ct_i;
                   d_sr_j = sum_i p (<h_j, ct_i> - inner_i) leaky'

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

v1 (per-edge weights and masks, for padded sampled subgraphs) is ROADMAP
queue 1, P9.
"""

from __future__ import annotations

import ctypes

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.ell_spmm import _L2_TILE_BYTES, MAX_BUCKETS

LAUNCHES = {"gat_rowmax": 0, "gat_v2_fwd": 0, "gat_v2_bwd_sl": 0,
            "gat_v2_bwd_h": 0}

SLOPE = 0.2
# Floor of the softmax denominator: a NORMAL float32 (1e-38 is subnormal
# and a flush-to-zero mode would turn an edgeless row's 1/z into inf).
Z_FLOOR = 1e-30
_MAX_TILE_V = 32                      # a group is at most one warp


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


# ---- the kernels' wrappers -------------------------------------------------

class _Table:
    """The per-bucket pointer, row-count and width arrays of a graph in
    launch order (widest bucket first), validated once. It is kept on the
    graph (``g.launch_tables``), whose tensors' addresses it holds, and
    lives as long as the graph."""

    def __init__(self, g: DeviceGraph):
        if not g.has_ell_layout:
            raise ValueError("DeviceGraph has no ELL buckets (no edges)")
        if len(g.ell) > MAX_BUCKETS:
            raise ValueError(f"{len(g.ell)} buckets, the kernels' table "
                             f"holds {MAX_BUCKETS}")
        buckets = sorted(g.ell, key=lambda b: -b.width)
        for b in buckets:
            for t, shape in ((b.row_ids, (b.rows,)), (b.valid, (b.rows,)),
                             (b.nbr, (b.rows * b.width,))):
                if (t.dtype != torch.int32 or tuple(t.shape) != shape
                        or not t.is_contiguous()
                        or t.device != g.is_split.device):
                    raise ValueError(
                        f"bucket of width {b.width}: ids must be contiguous "
                        f"int32 of shape {shape} on the graph's device")
        n = len(buckets)
        vp = ctypes.c_void_p
        self.args = (
            (vp * n)(*(b.row_ids.data_ptr() for b in buckets)),
            (vp * n)(*(b.nbr.data_ptr() for b in buckets)),
            (vp * n)(*(b.valid.data_ptr() for b in buckets)),
            (ctypes.c_int64 * n)(*(b.rows for b in buckets)),
            (ctypes.c_int32 * n)(*(b.width for b in buckets)),
            n, g.is_split.data_ptr())


def _table(g: DeviceGraph) -> _Table:
    table = g.launch_tables.get("fused_gat")
    if table is None:
        table = g.launch_tables["fused_gat"] = _Table(g)
    return table


def _check(g: DeviceGraph, vectors=(), matrices=()) -> torch.device:
    """Every operand float32, contiguous, on the graph's device, (nv,) or
    (nv, F) with one F. Returns the device."""
    dev = g.is_split.device
    f = matrices[0].shape[1] if matrices and matrices[0].dim() == 2 else None
    for t in (*vectors, *matrices):
        shape = (g.nv,) if any(t is v for v in vectors) else (g.nv, f)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"expected float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.device != dev:
            raise ValueError("graph and operands must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the GAT passes run on cpu or cuda, not {dev}")
    return dev


def _tile_floats(nv: int, f: int) -> int:
    """Feature columns per tile of the float4 instantiation: up to 128
    (one float4 per lane of a warp) while that slice of the gathered
    matrix fits the L2 budget of the SpMM kernel, else 64. Each tile
    repeats the per-slot scalar gathers and the exp, so narrower tiles
    than the SpMM's 32 pay: measured on an H100 (device times of
    tools/gat_kernels_probe.py, F = 128) 64 floats beat 32 by 2-4% at
    2^17 and 2^19 vertices and 128 by 2-6% at 2^19."""
    return min(f, 128 if nv * min(f, 128) * 4 <= _L2_TILE_BYTES else 64)


def _wide_shape(nv: int, f: int, *mats) -> tuple[int, int, int]:
    """(tile_v, vec, tiles) of a wide pass: V = float4 when F % 4 == 0
    and every matrix is aligned to 16 bytes, else float; a tile has at
    most 32 columns of V."""
    vec = int(f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in mats))
    tile_v = (_tile_floats(nv, f) // 4 if vec else min(f, _MAX_TILE_V))
    f_v = f // 4 if vec else f
    return tile_v, vec, -(-f_v // tile_v)


def _raise_on(rc: int, lib, name: str, detail: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({detail}): CUDA "
                           f"error {rc}: {lib.gab_cuda_error_string(rc).decode()}")


def _empty_but(g: DeviceGraph, like: torch.Tensor, shape, fill: float):
    """An uninitialised output in which only ``g.zero_rows`` (edgeless and
    split rows: the rows no kernel stores to) hold ``fill``."""
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    if g.zero_rows.numel():
        out.index_fill_(0, g.zero_rows, fill)
    return out


def _launch_tail(t: torch.Tensor) -> tuple:
    return (t.device.index, torch.cuda.current_stream(t.device).cuda_stream)


def gat_rowmax(g: DeviceGraph, sr: torch.Tensor) -> torch.Tensor:
    """m0_i = max over i's edges of sr_j; -inf for an edgeless row."""
    if _check(g, vectors=(sr,)).type == "cpu":
        return gat_rowmax_plain(g, sr)
    table = _table(g)
    lib = _build.load_library("fused_gat")
    m0 = _empty_but(g, sr, (g.nv,), float("-inf"))
    rc = lib.gab_gat_rowmax(*table.args, sr.data_ptr(), m0.data_ptr(),
                            *_launch_tail(sr))
    _raise_on(rc, lib, "gat_rowmax", f"{table.args[5]} buckets")
    LAUNCHES["gat_rowmax"] += 1
    return m0


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
    tile_v, vec, _ = _wide_shape(g.nv, f, h, acc)
    rc = lib.gab_gat_v2_fwd(*table.args, sl.data_ptr(), sr.data_ptr(),
                            m.data_ptr(), h.data_ptr(), acc.data_ptr(),
                            z.data_ptr(), f, tile_v, vec, *_launch_tail(h))
    _raise_on(rc, lib, "gat_v2_fwd", f"F={f}, tile_v={tile_v}, vec={vec}")
    LAUNCHES["gat_v2_fwd"] += 1
    return acc, z


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
    tile_v, vec, tiles = _wide_shape(g.nv, f, h, ct)
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


def gat_v2_bwd_h(g: DeviceGraph, sl, sr, m, zinv, inner, h, ct):
    """(d_h, d_sr) of the fused attention (pass B2, transpose role)."""
    dev = _check(g, vectors=(sl, sr, m, zinv, inner), matrices=(h, ct))
    if dev.type == "cpu":
        return gat_v2_bwd_h_plain(g, sl, sr, m, zinv, inner, h, ct)
    f = h.shape[1]
    if f == 0:
        raise ValueError("h has no columns")
    table = _table(g)
    lib = _build.load_library("fused_gat")
    # what the pass reads of a neighbour besides its row of ct, as one
    # 16-byte row per vertex
    pack = torch.stack([sl, m, zinv, inner], dim=1)
    d_h = _empty_but(g, h, (g.nv, f), 0.0)
    tile_v, vec, tiles = _wide_shape(g.nv, f, h, ct, d_h)
    d_sr = (sr.new_zeros(g.nv) if tiles > 1
            else _empty_but(g, sr, (g.nv,), 0.0))
    rc = lib.gab_gat_v2_bwd_h(
        *table.args, pack.data_ptr(), sr.data_ptr(), h.data_ptr(),
        ct.data_ptr(), d_h.data_ptr(), d_sr.data_ptr(), f, tile_v, vec,
        *_launch_tail(h))
    _raise_on(rc, lib, "gat_v2_bwd_h", f"F={f}, tile_v={tile_v}, vec={vec}")
    LAUNCHES["gat_v2_bwd_h"] += 1
    return d_h, d_sr


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
        d_sl = d_sr = d_h = None
        if ctx.needs_input_grad[1]:
            d_sl = gat_v2_bwd_sl(g, sl, sr, m, zinv, inner, h, ct)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            d_h, d_sr = gat_v2_bwd_h(g, sl, sr, m, zinv, inner, h, ct)
        return None, d_sl, d_sr, d_h


def gat_attention_spmm_v2(g: DeviceGraph, sl: torch.Tensor, sr: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    """out = softmax-weighted aggregation with logits
    leaky_relu(sl[src] + sr[dst]) computed inside the bucket passes.
    Requires all-ones edge weights and a structurally symmetric graph —
    the full-batch GAT case (gat_aggregator.cpp:57-102 semantics)."""
    return _GatV2.apply(g, sl, sr, h)
