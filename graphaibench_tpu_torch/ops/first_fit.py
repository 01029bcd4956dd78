"""The first-fit step of greedy vertex coloring: the hand-written CUDA kernel
K14 (``csrc/coloring.cu``) with its plain PyTorch version.

Counterpart of ``graphaibench_tpu/analytics/coloring.py::color``'s
``first_fit``, an XLA program of the JAX package. For every active row v:

    new[v] = the smallest c < max_colors that no neighbour u != v holds
             (colors[u]), or 0 where all max_colors colours are taken

and ``new[v] = colors[v]`` on inactive rows. JAX builds a dense (nv,
max_colors) forbidden matrix a round and takes each row's argmax; neither
version here builds it (13.6 GB at rmat19). The step reads ``colors`` and
returns a new tensor (Jacobi order, as JAX's rounds).

``first_fit`` takes the plain version for tensors on the CPU and launches the
kernel, once a call, for tensors on a CUDA device, or raises; ``LAUNCHES``
counts the launches. It reads the graph's CSR (``row_ptr``, ``col_idx``) and,
in the plain version, ``edge_src``; the rows above ``HUB_DEGREE``
neighbours, which the kernel gives a block each, are listed once per graph
and kept on it.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import _launch_tail, _raise_on
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph

LAUNCHES = {"first_fit": 0}

HUB_DEGREE = 1024          # kHubDegree of csrc/coloring.cu


def _check(g: DeviceGraph, colors: torch.Tensor, active: torch.Tensor,
           max_colors: int) -> torch.device:
    dev = g.col_idx.device
    for t, dtype in ((colors, torch.int32), (active, torch.bool)):
        if (t.dtype != dtype or tuple(t.shape) != (g.nv,)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"expected contiguous {dtype} of shape "
                             f"({g.nv},) on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= max_colors < 2**31:
        raise ValueError(f"max_colors must be in [1, 2^31), not {max_colors}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"first_fit runs on cpu or cuda, not {dev}")
    return dev


# ---- plain PyTorch version -------------------------------------------------

def first_fit_plain(g: DeviceGraph, colors: torch.Tensor,
                    active: torch.Tensor, max_colors: int) -> torch.Tensor:
    """The distinct (row, neighbour colour) pairs of the active rows, sorted:
    a row's k-th smallest colour is k until its first gap, which is the
    answer (or the number of colours the row sees, where there is none)."""
    _check(g, colors, active, max_colors)
    src, dst = g.edge_src.long(), g.col_idx.long()
    c = colors.long()[dst]
    keep = (src != dst) & active[src] & (c < max_colors)
    keys = torch.unique(src[keep] * max_colors + c[keep])   # sorted
    rows, cols = keys // max_colors, keys % max_colors
    seen = torch.zeros(g.nv, dtype=torch.int64, device=colors.device)
    seen.index_add_(0, rows, torch.ones_like(rows))
    first = torch.cumsum(seen, 0) - seen        # each row's first key
    rank = torch.arange(len(keys), device=colors.device) - first[rows]
    mex = seen.clone()
    gap = cols != rank
    mex.scatter_reduce_(0, rows[gap], rank[gap], "amin")
    mex = torch.where(mex < max_colors, mex, torch.zeros_like(mex))
    return torch.where(active, mex.to(torch.int32), colors)


# ---- the kernel's wrapper --------------------------------------------------

def _hubs(g: DeviceGraph) -> torch.Tensor:
    hubs = g.launch_tables.get("first_fit")
    if hubs is None:
        hubs = torch.nonzero(g.deg > HUB_DEGREE).flatten().to(torch.int32)
        g.launch_tables["first_fit"] = hubs
    return hubs


def first_fit(g: DeviceGraph, colors: torch.Tensor, active: torch.Tensor,
              max_colors: int) -> torch.Tensor:
    """One first-fit round from ``colors`` ((nv,) int32) on the ``active``
    rows ((nv,) bool): the new (nv,) int32 colours."""
    dev = _check(g, colors, active, max_colors)
    if dev.type == "cpu":
        return first_fit_plain(g, colors, active, max_colors)
    hubs = _hubs(g)
    lib = _build.load_library("coloring")
    out = torch.empty_like(colors)
    rc = lib.gab_first_fit(
        g.row_ptr.data_ptr(), g.col_idx.data_ptr(), colors.data_ptr(),
        active.data_ptr(), hubs.data_ptr(), hubs.numel(), g.nv, max_colors,
        out.data_ptr(), *_launch_tail(colors))
    _raise_on(rc, lib, "first_fit",
              f"{g.nv} rows, {hubs.numel()} hubs, max_colors {max_colors}")
    LAUNCHES["first_fit"] += 1
    return out
