"""k-core decomposition.

Counterpart of ``graphaibench_tpu/analytics/kcore.py``, two formulations:

* ``k_core_hindex`` (with the host CSR) — the h-index fixpoint (Lu et al.
  2016): core_0 = deg, core_{t+1}[v] = min(core_t[v], H(core_t[N(v)])),
  which converges to the coreness with all levels peeling at once (32
  sweeps on rmat(17, 16)). A sweep is the kernel K10 (``ops/hindex.py``)
  on a CUDA device, over the CSR with whole rows: the h-index of a row does
  not decompose over the split virtual rows of the ELL layout. The host
  reads the changed count once a sweep.

* ``k_core_peel`` — bulk peeling, the reference's shape
  (src/coreness/omp_base.cc:11-60): peel every vertex of live degree <= k
  at once, a host-driven loop over the levels k. The live degrees are one
  pull of K8 ``neighbor_reduce`` (an int32 sum) on a graph with ELL buckets,
  an ``index_add_`` over the edge list otherwise (the push route of directed
  inputs). For device-graph-only callers and as a cross-check.

The JAX package's ``GAB_KCORE_SORT`` switch (a sort in place of the binary
search, an A/B knob: the h-index is exact either way) is not carried.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.ops import hindex as K10
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph, _pack_rows
from graphaibench_tpu_torch.ops.segment import neighbor_reduce

INT_MAX = torch.iinfo(torch.int32).max

# ---------------------------------------------------------------------------
# h-index fixpoint
# ---------------------------------------------------------------------------


def _hindex_layout(g: CSRGraph) -> tuple:
    """The no-split degree-bucketed ELL of the plain version: pow2 widths
    {4..max_degree}, each row whole in one virtual row, ``((width, row_ids,
    nbr, edge_id), ...)`` in numpy with flat slot arrays, pads at edge id
    ``g.ne``."""
    deg = g.degrees().astype(np.int64)
    if g.nv == 0 or g.ne == 0:
        return ()
    maxdeg = int(deg.max())
    split = 4
    while split < maxdeg:
        split *= 2
    widths = [4]
    while widths[-1] < split:
        widths.append(widths[-1] * 2)
    return tuple(_pack_rows(np.arange(g.nv, dtype=np.int32),
                            g.row_ptr[:-1], deg, g.col_idx, None, g.ne,
                            widths, split))


_row_hindex = K10.row_hindex


def _hindex_sweep(core: torch.Tensor, layout: K10.HindexLayout):
    """One fixpoint sweep: (new, changed), new[v] = min(core[v],
    H(core[N(v)]))."""
    return K10.hindex_sweep(layout, core)


def hindex_state(g: CSRGraph, *, device="cuda",
                 with_plain: Optional[bool] = None) -> K10.HindexLayout:
    """The layout the sweeps read, on ``device``; with the plain version's
    buckets on the CPU, or where ``with_plain`` asks for them."""
    if with_plain is None:
        with_plain = torch.device(device).type == "cpu"
    return K10.hindex_layout(g.row_ptr, g.col_idx,
                             _hindex_layout(g) if with_plain else None,
                             device=device)


def k_core_hindex(g: CSRGraph, deg: Optional[torch.Tensor] = None,
                  layout: Optional[K10.HindexLayout] = None, *,
                  device="cuda") -> torch.Tensor:
    """Coreness via the h-index fixpoint on ``device`` (host CSR input;
    builds its own layout unless ``layout`` was built by ``hindex_state``).
    One host sync a sweep, on the changed count."""
    if layout is None:
        layout = hindex_state(g, device=device)
    core = (torch.from_numpy(g.degrees().astype(np.int32)).to(
        layout.rows.device) if deg is None else deg)
    if layout.ne == 0:
        return core
    while True:
        core, changed = _hindex_sweep(core, layout)
        if int(changed) == 0:
            return core


# ---------------------------------------------------------------------------
# bulk peeling (the DeviceGraph-only path)
# ---------------------------------------------------------------------------


def _live_degrees(g: DeviceGraph, alive: torch.Tensor) -> torch.Tensor:
    """Live degree of each live vertex (0 for the dead): the int32 sum of
    alive over the neighbours."""
    if g.has_ell_layout:
        nbr_alive = neighbor_reduce(g, alive.to(torch.int32), "sum")
        return torch.where(alive, nbr_alive, 0)
    contrib = (alive[g.edge_src.long()] & alive[g.col_idx.long()]).to(
        torch.int32)
    return torch.zeros(g.nv, dtype=torch.int32,
                       device=alive.device).index_add_(0, g.edge_src, contrib)


def _peel_level(g: DeviceGraph, core, alive, deg, k: int):
    """Fixpoint at level k: repeatedly peel the live vertices of degree
    <= k until none is left. Returns (core, alive, deg, the least live
    degree or INT_MAX). One host sync a peel, on whether it peeled."""
    while True:
        peel = alive & (deg <= k)
        if not bool(peel.any()):
            break
        core = torch.where(peel, k, core)
        alive = alive & ~peel
        deg = _live_degrees(g, alive)
    min_live = torch.where(alive, deg, INT_MAX).min()
    return core, alive, deg, min_live


def k_core_peel(g: DeviceGraph) -> torch.Tensor:
    """Bulk-peel coreness (matches transforms.k_core_decomposition)."""
    dev = g.deg.device
    core = torch.zeros(g.nv, dtype=torch.int32, device=dev)
    if g.nv == 0:
        return core
    alive = torch.ones(g.nv, dtype=torch.bool, device=dev)
    deg = _live_degrees(g, alive)
    k = 0
    while True:
        core, alive, deg, min_live = _peel_level(g, core, alive, deg, k)
        nxt = int(min_live)          # host sync: ends the level
        if nxt == INT_MAX:           # nothing alive
            return core
        k = max(k + 1, nxt)


def k_core(g: Optional[DeviceGraph], host: Optional[CSRGraph] = None, *,
           device="cuda") -> torch.Tensor:
    """Coreness of every vertex (matches transforms.k_core_decomposition).
    With the host CSR the h-index fixpoint runs (tens of sweeps), on the
    device graph's device or else on ``device``; without it the bulk-peel
    host loop on the device graph."""
    if host is not None:
        return k_core_hindex(host, device=(device if g is None
                                           else g.deg.device))
    return k_core_peel(g)
