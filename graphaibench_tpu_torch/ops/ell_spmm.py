"""The ELL SpMM: kernel K1 (CUDA C++, ``csrc/ell_spmm.cu``) and its plain
PyTorch version.

Counterpart of ``graphaibench_tpu/ops/pallas_spmm.py`` (``_bucket_kernel``
launched per bucket by ``spmm_ell_pallas``). For each degree bucket b of
``g.ell`` with slot weights ``w_slots[i]`` (flat (R*W,), aligned with the
bucket's ``nbr``):

    out[b.row_ids[r], :] += sum_j w_slots[i][r*W + j] * x[b.nbr[r*W + j], :]

``ell_spmm`` takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device, or raises; it never moves work
between devices. One SpMM is one kernel launch over all buckets, and
``LAUNCHES`` counts those launches, so a run can show that its SpMMs went
through the kernel.

The graph may be rectangular: x has ``g.n_cols`` rows (those the
neighbour ids index), the output ``g.nv`` (those the row ids index).

The kernel stores a row that has one virtual row and adds (atomics) the
pieces of a row that is split, so the wrapper hands it an uninitialised
output in which only ``g.zero_rows`` (degree 0, and split rows) are zero.
Unsplit rows are therefore bit-reproducible; split rows are summed in an
order that changes from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph, SlotWeights

LAUNCHES = 0

MAX_BUCKETS = 8                       # kMaxBuckets of csrc/ell_spmm.cu
_VEC_WIDTHS = frozenset((4, 8, 16, 32, 64))
# Bytes of x that one feature tile may span. The kernel gathers all rows
# of one tile before the next tile's, so a tile of x within this budget
# stays in the 50 MB L2 beside the output tile and the streamed ids.
_L2_TILE_BYTES = 24 << 20


def _tile_floats(n_rows: int, f: int) -> int:
    """Feature columns per tile of the vector instantiation: the widest
    of 128, 64, 32 (a lane holds one float4, a group at most 32 lanes;
    32 floats are one 128-byte line) whose slice of x (``n_rows`` rows)
    fits the budget, and never wider than F."""
    for tile in (128, 64, 32):
        if n_rows * min(tile, f) * 4 <= _L2_TILE_BYTES:
            break
    return min(tile, f)


class _LaunchTable:
    """What one (graph, weight view) pair hands the kernel at every call:
    the per-bucket pointer, row-count and width arrays in launch order
    (widest bucket first), validated once when the table is built. It
    keeps the graph and the weights alive, since it holds their
    addresses."""

    def __init__(self, g: DeviceGraph, w_slots):
        if len(w_slots) != len(g.ell):
            raise ValueError(f"{len(w_slots)} slot-weight arrays for "
                             f"{len(g.ell)} buckets")
        if len(g.ell) > MAX_BUCKETS:
            raise ValueError(f"{len(g.ell)} buckets, the kernel's table "
                             f"holds {MAX_BUCKETS}")
        self.graph, self.w_slots = g, w_slots
        self.device = g.is_split.device
        if g.is_split.dtype != torch.uint8 or g.is_split.shape != (g.nv,):
            raise ValueError("is_split must be uint8 of shape (nv,)")
        if g.zero_rows.device != self.device:
            raise ValueError("graph, weights and x must be on one device")
        for b, w in zip(g.ell, w_slots):
            if w.dtype != torch.float32 or tuple(w.shape) != tuple(b.nbr.shape):
                raise ValueError(
                    f"bucket of width {b.width}: slot weights must be float32 of "
                    f"shape {tuple(b.nbr.shape)}, got {w.dtype} {tuple(w.shape)}")
            if not (self.device == w.device == b.nbr.device
                    == b.row_ids.device):
                raise ValueError("graph, weights and x must be on one device")
            if not w.is_contiguous():
                raise ValueError("slot weights must be contiguous")
            if b.row_ids.dtype != torch.int32 or b.nbr.dtype != torch.int32:
                raise ValueError("bucket ids must be int32")
        order = sorted(range(len(g.ell)), key=lambda i: -g.ell[i].width)
        buckets = [g.ell[i] for i in order]
        weights = [w_slots[i] for i in order]
        n = len(order)
        self.n = n
        self.row_ids = (ctypes.c_void_p * n)(*(b.row_ids.data_ptr() for b in buckets))
        self.nbr = (ctypes.c_void_p * n)(*(b.nbr.data_ptr() for b in buckets))
        self.w = (ctypes.c_void_p * n)(*(w.data_ptr() for w in weights))
        self.rows = (ctypes.c_int64 * n)(*(b.rows for b in buckets))
        self.widths = (ctypes.c_int32 * n)(*(b.width for b in buckets))
        # what the vector instantiation needs of the graph and weights
        self.vec_ok = all(
            b.width in _VEC_WIDTHS and b.nbr.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0 for b, w in zip(buckets, weights))


def _launch_table(g: DeviceGraph, w_slots) -> _LaunchTable:
    """The pair's table: built (and the pair validated) at its first SpMM
    and kept on a ``SlotWeights``; a plain tuple gets a new one per call."""
    table = getattr(w_slots, "launch_table", None)
    if table is None or table.graph is not g:
        table = _LaunchTable(g, w_slots)
        if isinstance(w_slots, SlotWeights):
            w_slots.launch_table = table
    return table


def _check_x(g: DeviceGraph, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] != g.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows, the graph gathers from "
                         f"{g.n_cols}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def ell_spmm_plain(g: DeviceGraph, w_slots, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: per bucket, gather (R, W, F) from the
    ``g.n_cols`` rows of x, weight, sum over W, index_add into the
    ``g.nv`` output rows."""
    out = x.new_zeros((g.nv, x.shape[1]))
    for b, w in zip(g.ell, w_slots):
        nbr = b.nbr.view(b.rows, b.width)
        contrib = (w.view(b.rows, b.width, 1) * x[nbr]).sum(1)
        out.index_add_(0, b.row_ids, contrib)
    return out


def _ell_spmm_cuda(table: _LaunchTable, x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    g = table.graph
    f = x.shape[1]
    if table.n == 0 or f == 0:
        return x.new_zeros((g.nv, f))
    lib = _build.load_library("ell_spmm")
    out = torch.empty((g.nv, f), dtype=x.dtype, device=x.device)
    if g.zero_rows.numel():
        out.index_fill_(0, g.zero_rows, 0.0)
    # float4 loads need F % 4 == 0 and 16-byte alignment (a contiguous
    # view with a storage offset is legal input); below F = 4 the narrow
    # instantiation (a thread a row) takes the aligned tables (-1), the
    # scalar instantiation (a warp a row) the rest (0)
    vec = (table.vec_ok and f % 4 == 0 and x.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    # the budget is for the slice of x a tile gathers from
    tile_f4 = (_tile_floats(g.n_cols, f) // 4 if vec
               else -1 if table.vec_ok and f < 4 else 0)
    rc = lib.gab_ell_spmm(
        table.row_ids, table.nbr, table.w, table.rows, table.widths, table.n,
        g.is_split.data_ptr(), x.data_ptr(), out.data_ptr(), f, tile_f4,
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.gab_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"ell_spmm kernel launch failed ({table.n} buckets, widths "
            f"{list(table.widths)}, F={f}, tile_f4={tile_f4}): CUDA error "
            f"{rc}: {msg}")
    LAUNCHES += 1
    return out


def ell_spmm(g: DeviceGraph, w_slots, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMM over every bucket of ``g``: the kernel on a CUDA device,
    the plain version on the CPU. ``w_slots`` holds the per-bucket slot
    weights (``PackedEdgeW.fwd`` or ``.t``, or any tuple aligned with
    ``g.ell``)."""
    _check_x(g, x)
    table = _launch_table(g, w_slots)
    if x.device != table.device:
        raise ValueError("graph, weights and x must be on one device")
    if x.device.type == "cpu":
        return ell_spmm_plain(g, w_slots, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmm runs on cpu or cuda, not {x.device}")
    return _ell_spmm_cuda(table, x)
