"""One sweep of k-core's h-index fixpoint: the hand-written CUDA kernel K10
(``csrc/kcore_hindex.cu``) with its plain PyTorch version.

Counterpart of ``graphaibench_tpu/analytics/kcore.py::_row_hindex`` and
``_hindex_sweep``, an XLA program of the JAX package. On a symmetric graph:

    new[v] = min(core[v], H(core[N(v)])),  H(x) = max t with #{x_i >= t} >= t
    changed = #{v : new[v] != core[v]}

a vertex without neighbours keeping its value. The sweep reads ``core`` and
writes a new tensor (Jacobi order, as in JAX: the sweep count is JAX's).

``hindex_layout`` moves a graph to the device once: its CSR and its
vertices in the kernel's order (the hubs, rows of more than 1024
neighbours, widest first, each a block; then the classes of rows of up to
8, 16, 32, 64, 128 and 1024 neighbours), and, for the plain version, the
JAX package's no-split ELL buckets. ``hindex_sweep`` takes the plain
version for tensors on the CPU and launches the kernel for tensors on a
CUDA device, or raises; ``LAUNCHES`` counts its calls on a CUDA device,
one a sweep, each of which launches the one kernel. Both return ``(new,
changed)``, ``changed`` a 0-d int32 tensor on the device, read once a
sweep by the caller. Core values are non-negative.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import _launch_tail, _raise_on

LAUNCHES = {"hindex_sweep": 0}

# The kernel's classes of rows after the hubs, by the most neighbours a row
# of each has; wider rows are hubs.
CLASS_WIDTHS = (8, 16, 32, 64, 128, 1024)


@dataclasses.dataclass(frozen=True)
class HindexLayout:
    """A symmetric graph on the device, as K10 and its plain version read
    it."""

    row_ptr: torch.Tensor      # (nv + 1,) int32
    col_idx: torch.Tensor      # (ne,) int32
    rows: torch.Tensor         # (nv,) int32 — every vertex: hubs, classes
    class_start: tuple         # 8 ints: the hubs are rows[[0], [1]), class
                               # c rows[[c + 1], [c + 2])
    hub_width: int             # the most neighbours of a hub (0: no hub)
    # the plain version's no-split buckets, ((width, row_ids, nbr,
    # edge_id), ...) with flat slot arrays, pads at edge id ne; None when
    # the layout was built without them
    buckets: tuple | None
    nv: int
    ne: int


def hindex_layout(row_ptr: np.ndarray, col_idx: np.ndarray, buckets, *,
                  device) -> HindexLayout:
    """The layout of a host CSR graph on ``device``; ``buckets`` are the
    no-split buckets in numpy (``analytics/kcore.py::_hindex_layout``), or
    None for a layout that only the kernel reads."""
    row_ptr = np.asarray(row_ptr, np.int64)
    nv, ne = len(row_ptr) - 1, len(col_idx)
    if ne >= 2**31:
        raise ValueError("edge count must fit int32")
    deg = np.diff(row_ptr)
    # the hubs as class -1, each by its degree, widest first
    cls = np.searchsorted(np.asarray(CLASS_WIDTHS), deg, side="left")
    hubs = deg > CLASS_WIDTHS[-1]
    cls[hubs] = -1
    order = np.lexsort((np.where(hubs, -deg, 0), cls)).astype(np.int32)
    start = np.concatenate([[0], np.cumsum(
        np.bincount(cls + 1, minlength=len(CLASS_WIDTHS) + 1))])

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return HindexLayout(
        row_ptr=to(row_ptr), col_idx=to(col_idx), rows=to(order),
        class_start=tuple(int(s) for s in start),
        hub_width=int(deg[hubs].max()) if hubs.any() else 0,
        buckets=(None if buckets is None else tuple(
            (int(w), to(r), to(n), to(e)) for (w, r, n, e) in buckets)),
        nv=nv, ne=ne)


# ---- plain PyTorch version -------------------------------------------------

def row_hindex(vals: torch.Tensor, w: int) -> torch.Tensor:
    """Per-row h-index of an (r, w) block clamped to w: binary search on
    h in [0, w] (cnt(>= t) does not grow with t, so h = max t with
    cnt(>= t) >= t searches exactly), as the JAX package's default."""
    lo = torch.zeros(vals.shape[0], dtype=vals.dtype, device=vals.device)
    hi = torch.full_like(lo, w)
    steps = max(int(np.ceil(np.log2(w + 1))), 1)
    for _ in range(steps + 1):
        mid = (lo + hi + 1) >> 1
        cnt = (vals >= mid[:, None]).sum(1, dtype=vals.dtype)
        ok = cnt >= mid
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    return lo


def hindex_sweep_plain(layout: HindexLayout, core: torch.Tensor):
    """Per no-split bucket: the neighbours' values gathered, 0 in the pads,
    clamped to the width, the rows' h-index, and its minimum with core."""
    if layout.buckets is None:
        raise ValueError("the layout was built without the plain version's "
                         "buckets")
    new = core.clone()
    for w, rows, nbr, eid in layout.buckets:
        vals = core[nbr.long()].view(-1, w)
        vals = torch.where(eid.view(-1, w) == layout.ne, 0, vals)
        # h <= the row's degree <= w: clamping keeps h exact and the
        # search short
        vals = vals.clamp(max=w)
        new.scatter_reduce_(0, rows.long(), row_hindex(vals, w), "amin")
    return new, (new != core).sum(dtype=torch.int32)


# ---- the kernel's wrapper --------------------------------------------------

def hindex_sweep(layout: HindexLayout, core: torch.Tensor):
    """One sweep from ``core`` ((nv,) int32 on the layout's device):
    ``(new, changed)``."""
    dev = layout.rows.device
    if (core.dtype != torch.int32 or tuple(core.shape) != (layout.nv,)
            or not core.is_contiguous() or core.device != dev):
        raise ValueError(f"core must be contiguous int32 of shape "
                         f"({layout.nv},) on {dev}, got {core.dtype} "
                         f"{tuple(core.shape)} on {core.device}")
    if dev.type == "cpu":
        return hindex_sweep_plain(layout, core)
    if dev.type != "cuda":
        raise ValueError(f"hindex_sweep runs on cpu or cuda, not {dev}")
    lib = _build.load_library("kcore_hindex")
    out = torch.empty_like(core)
    changed = torch.empty((), dtype=torch.int32, device=dev)
    starts = (ctypes.c_int64 * len(layout.class_start))(*layout.class_start)
    rc = lib.gab_hindex_sweep(
        layout.row_ptr.data_ptr(), layout.col_idx.data_ptr(), core.data_ptr(),
        layout.rows.data_ptr(), starts, out.data_ptr(), changed.data_ptr(),
        *_launch_tail(core))
    _raise_on(rc, lib, "hindex_sweep",
              f"{layout.nv} rows, widest hub {layout.hub_width}")
    LAUNCHES["hindex_sweep"] += 1
    return out, changed
