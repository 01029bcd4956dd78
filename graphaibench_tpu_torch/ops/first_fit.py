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
in the plain version, ``edge_src``. The kernel's tables
(``first_fit_tables``) are built once per graph and kept on it: the rows
above ``HUB_DEGREE`` neighbours, each cut into slices of ``HUB_SLICE`` ids
that the kernel gives a block each and that combine their marks in a
scratch of the tables (so launches on one graph run one after another, on
one stream), and the other rows in chunks of ``CHUNK`` entries, a warp a
chunk, grouped by degree so that a chunk's rows share a lane width.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import _launch_tail, _raise_on
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph

LAUNCHES = {"first_fit": 0}

HUB_DEGREE = 1024          # kHubDegree of csrc/coloring.cu
HUB_SLICE = 4096           # kHubSlice: a hub's ids a block
CHUNK = 32                 # kChunk: table entries a warp, a lane each
LOW_WORDS = 4              # kLowWords: a hub's scratch holds these and a count
# The table's classes, in its order: (least degree, most degree, rows a
# chunk). The widest rows come first (the launch starts their warps first);
# rows above 64 neighbours take the warp's 32 lanes one after another, so
# they come 8 or 1 to a chunk; rows of up to 16, 32 or 64 share a warp in
# groups of 4, 8 or 16 lanes. Padding entries are -1.
ROW_CLASSES = ((129, HUB_DEGREE, 1), (65, 128, 8), (33, 64, CHUNK),
               (17, 32, CHUNK), (0, 16, CHUNK))


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

def first_fit_tables(deg: torch.Tensor, hub_degree: int = HUB_DEGREE,
                     classes=ROW_CLASSES, hub_slice: int | None = None) -> dict:
    """The kernel's tables for rows of degrees ``deg`` (on its device):
    ``hubs`` (int32), the rows above ``hub_degree``; ``order`` (int32,
    ``CHUNK`` entries a chunk), the other rows by ``classes``, each class's
    rows in id order, ``rows`` of them a chunk and the rest of the chunk -1;
    ``n_chunks``; ``slices`` ((n_slices, 2) int32), (index into ``hubs``,
    slice number) for every ``hub_slice`` (``HUB_SLICE``) ids of each hub's
    row; ``hub_words``, the kernel's scratch, LOW_WORDS + 1 int32 a hub. A
    row no class holds takes a chunk of its own."""
    deg = deg.long()
    hubs = torch.nonzero(deg > hub_degree).flatten().to(torch.int32)
    hub_slice = hub_slice or HUB_SLICE
    per = (deg[hubs.long()] + hub_slice - 1) // hub_slice
    owner = torch.repeat_interleave(
        torch.arange(hubs.numel(), device=deg.device), per)
    first = torch.cumsum(per, 0) - per
    slices = torch.stack(
        [owner, torch.arange(owner.numel(), device=deg.device) - first[owner]],
        1).to(torch.int32)
    left = deg <= hub_degree
    parts = []
    for least, most, rows in [*classes, (0, hub_degree, 1)]:
        pick = left & (deg >= least) & (deg <= most)
        left &= ~pick
        ids = torch.nonzero(pick).flatten().to(torch.int32)
        n = -(-ids.numel() // rows)
        t = torch.full((n, CHUNK), -1, dtype=torch.int32, device=deg.device)
        pad = torch.full((n * rows - ids.numel(),), -1, dtype=torch.int32,
                         device=deg.device)
        t[:, :rows] = torch.cat([ids, pad]).view(n, rows)
        parts.append(t.flatten())
    order = torch.cat(parts)
    return {"hubs": hubs, "slices": slices,
            "hub_words": torch.zeros(hubs.numel() * (LOW_WORDS + 1),
                                     dtype=torch.int32, device=deg.device),
            "order": order, "n_chunks": order.numel() // CHUNK}


def _tables(g: DeviceGraph) -> dict:
    tables = g.launch_tables.get("first_fit")
    if tables is None:
        tables = first_fit_tables(g.deg)
        g.launch_tables["first_fit"] = tables
    return tables


def first_fit(g: DeviceGraph, colors: torch.Tensor, active: torch.Tensor,
              max_colors: int) -> torch.Tensor:
    """One first-fit round from ``colors`` ((nv,) int32) on the ``active``
    rows ((nv,) bool): the new (nv,) int32 colours."""
    dev = _check(g, colors, active, max_colors)
    if dev.type == "cpu":
        return first_fit_plain(g, colors, active, max_colors)
    t = _tables(g)
    hubs = t["hubs"]
    lib = _build.load_library("coloring")
    out = torch.empty_like(colors)
    rc = lib.gab_first_fit(
        g.row_ptr.data_ptr(), g.col_idx.data_ptr(), colors.data_ptr(),
        active.data_ptr(), hubs.data_ptr(), hubs.numel(),
        t["slices"].data_ptr(), t["slices"].shape[0],
        t["hub_words"].data_ptr(), t["order"].data_ptr(), t["n_chunks"],
        max_colors, out.data_ptr(), *_launch_tail(colors))
    _raise_on(rc, lib, "first_fit",
              f"{g.nv} rows, {hubs.numel()} hubs, {t['n_chunks']} chunks, "
              f"max_colors {max_colors}")
    LAUNCHES["first_fit"] += 1
    return out
