"""BFS and SSSP as dense edge-parallel fixpoint iterations.

Counterpart of ``graphaibench_tpu/analytics/traversal.py``, the dense
replacement of the reference's worklist solvers (src/traversal: SlidingQueue
+ CAS push BFS omp_base.cc:8-57, direction-optimizing omp_direction.cc,
Bellman-Ford / delta-stepping SSSP): every sweep updates dense frontier or
distance vectors. With the graph's ELL buckets a sweep is one pull, the
kernel ``neighbor_reduce`` (``ops/ell_pull.py``), which assumes a
structurally symmetric graph (the reference's BFS inputs are); without them
it is a push, a scatter over the (ne,) edge list in plain PyTorch, which
stays right on directed inputs.

Each ``jax.lax.while_loop`` of the JAX module is a Python loop here that
reads its convergence flag once a sweep: one host sync a sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.segment import (
    neighbor_reduce,
    pack_neighbor_edge_vals,
)

BIG = 1 << 30     # stands in for "unreached" in the pull BFS


def _start(g: DeviceGraph, source: int, fill, dtype, at):
    out = torch.full((g.nv,), fill, dtype=dtype, device=g.deg.device)
    out[source] = at
    return out


def _pull_bfs_sweep(g: DeviceGraph, dist: torch.Tensor):
    """(the unreached vertices with a reached neighbour as a mask, the
    least depth among each vertex's neighbours). A caller adds 1 to the
    depth only where the mask holds: the min's identity (INT_MAX) on
    edgeless or unreached rows would wrap."""
    cand = neighbor_reduce(g, torch.where(dist < 0, BIG, dist), "min")
    return (dist < 0) & (cand < BIG), cand


def bfs(g: DeviceGraph, source: int) -> torch.Tensor:
    """Level-synchronous BFS. Returns int32 depths, -1 if unreachable.

    With ELL buckets the sweep pulls (min over the neighbours' depths, the
    reference's direction-optimizing pull pass, omp_direction.cc:31); the
    (ne,)-scatter push is the route of graphs without buckets. Pull assumes
    a symmetric graph."""
    dist = _start(g, source, -1, torch.int32, 0)
    if g.has_ell_layout:
        while True:
            reach, cand = _pull_bfs_sweep(g, dist)
            new = torch.where(reach, cand + 1, dist)
            changed = bool((new != dist).any())
            dist = new
            if not changed:
                return dist

    src, dst = g.edge_src.long(), g.col_idx.long()
    frontier = _start(g, source, False, torch.bool, True)
    level = 0
    while bool(frontier.any()):
        # push step: any edge from a frontier vertex reaches dst
        reached = torch.zeros(g.nv, dtype=torch.int32, device=dist.device)
        reached.scatter_reduce_(0, dst, frontier[src].int(), "amax")
        frontier = (reached > 0) & (dist < 0)
        dist = torch.where(frontier, level + 1, dist)
        level += 1
    return dist


def sssp_bellman_ford(g: DeviceGraph, weights: torch.Tensor, source: int, *,
                      max_iter: int | None = None) -> torch.Tensor:
    """Bellman-Ford to fixpoint (the reference's gpu_bellmanford shape).
    Returns float32 distances, inf unreachable.

    The pull relaxes dist[r] over the slots of row r, whose edges are the
    OUTGOING ones (r -> j); the relaxation needs the reverse edge's weight,
    w(j -> r). On a structurally symmetric graph ``trans_perm[k]`` is the
    edge id of edge k's reversal, so the weights gathered through it, and
    packed into the slot layout once per call, feed each slot its incoming
    weight. Without the transpose permutation the pull would mis-relax
    asymmetric weights, so such graphs take the push scatter."""
    max_iter = g.nv if max_iter is None else max_iter
    src, dst = g.edge_src.long(), g.col_idx.long()
    pull = g.has_ell_layout and g.trans_perm is not None
    w_pull = (pack_neighbor_edge_vals(g, weights[g.trans_perm.long()], "min")
              if pull else None)
    dist = _start(g, source, float("inf"), torch.float32, 0.0)
    it = 0
    changed = True
    while changed and it < max_iter:
        if pull:
            cand = neighbor_reduce(g, dist, "min", edge_vals=w_pull)
        else:
            cand = torch.full_like(dist, float("inf")).scatter_reduce_(
                0, dst, dist[src] + weights, "amin")
        new = torch.minimum(dist, cand)
        changed = bool((new < dist).any())
        dist = new
        it += 1
    return dist


def sssp_delta_stepping(g: DeviceGraph, weights: torch.Tensor, source: int, *,
                        delta: float | None = None,
                        max_outer: int | None = None) -> torch.Tensor:
    """Delta-stepping SSSP (the reference's omp_dstep.cc / gpu_dstep.cu) as
    a dense bucketed fixpoint.

    Buckets are processed in distance order; within a bucket only edges
    whose source is settled into the bucket relax (light edges to an inner
    fixpoint, then heavy edges once). The buckets bound the sweeps by
    max_weight / delta + diameter instead of nv on high-diameter weighted
    graphs. The pull gathers both weight views through ``trans_perm`` (see
    ``sssp_bellman_ford``) and packs them once per call. Returns float32
    distances, inf unreachable."""
    if delta is None:
        delta = float(weights.mean()) + 1e-9 if weights.numel() else 1.0
    max_outer = g.nv if max_outer is None else max_outer
    src, dst = g.edge_src.long(), g.col_idx.long()
    inf = float("inf")
    delta_t = torch.tensor(delta, dtype=torch.float32, device=weights.device)
    light = weights <= delta_t
    pull = g.has_ell_layout and g.trans_perm is not None
    if pull:
        perm = g.trans_perm.long()
        w_rev, light_rev = weights[perm], light[perm]
        # two static masked views, packed into the slot layout once per call
        w_light = pack_neighbor_edge_vals(
            g, torch.where(light_rev, w_rev, inf), "min")
        w_heavy = pack_neighbor_edge_vals(
            g, torch.where(~light_rev, w_rev, inf), "min")
    else:
        w_light = w_heavy = None

    def relax(dist, active, mask, packed_w):
        """One relaxation of the edges whose source is active (and which
        the static edge mask keeps)."""
        if pull:
            cand = neighbor_reduce(g, torch.where(active, dist, inf), "min",
                                   edge_vals=packed_w)
        else:
            contrib = torch.where(active[src] & mask, dist[src] + weights, inf)
            cand = torch.full_like(dist, inf).scatter_reduce_(
                0, dst, contrib, "amin")
        return torch.minimum(dist, cand)

    dist = _start(g, source, inf, torch.float32, 0.0)
    k = torch.zeros((), dtype=torch.float32, device=weights.device)
    it = 0
    while bool(k < inf) and it < max_outer:
        lo, hi = k * delta_t, (k + 1) * delta_t
        # inner fixpoint over the light edges of this bucket (the active
        # mask is recomputed each relaxation: vertices can fall INTO the
        # current bucket mid-phase)
        changed = True
        while changed:
            nd = relax(dist, (dist >= lo) & (dist < hi), light, w_light)
            changed = bool((nd < dist).any())
            dist = nd
        # heavy edges once
        dist = relax(dist, (dist >= lo) & (dist < hi), ~light, w_heavy)
        # advance to the next non-empty bucket
        remaining = torch.where(dist >= hi, dist, inf)
        k = (torch.floor(remaining.min() / delta_t)
             if bool(torch.isfinite(remaining).any())
             else torch.tensor(inf, device=dist.device))
        it += 1
    return dist


def bfs_frontier(g: DeviceGraph, source: int, *,
                 edge_budget: int | None = None) -> torch.Tensor:
    """Frontier-density-adaptive BFS, the translation of the reference's
    direction-optimizing switch (omp_direction.cc:31).

    Each level, the frontier's total out-degree picks the sweep:

    * sparse (``front_edges <= edge_budget``): expand the frontier's CSR
      adjacency slices and mark level + 1 at the destinations; work per
      sweep O(nv + frontier edges) instead of O(E). The JAX package does
      this with static-size buffers; here the shapes follow the frontier.
    * dense: the pull sweep ``neighbor_reduce`` (or the (ne,) scatter when
      the graph has no ELL buckets).

    Default budget: ne/16 rounded up to a power of two, at least 2^14, at
    most ne. Right on directed and undirected graphs (the sparse sweep
    pushes over out-edges; the pull is taken only with ELL buckets, which
    the callers build for symmetric inputs only)."""
    nv, ne = g.nv, g.ne
    if edge_budget is None:
        edge_budget = max(1 << 14, 1 << int(np.ceil(np.log2(max(ne, 16) / 16))))
    edge_budget = min(edge_budget, max(ne, 1))
    deg, row_ptr = g.deg, g.row_ptr.long()
    src, dst = g.edge_src.long(), g.col_idx.long()
    dist = _start(g, source, -1, torch.int32, 0)
    frontier = _start(g, source, False, torch.bool, True)
    level = 0

    def sparse_sweep(dist, frontier):
        ids = torch.nonzero(frontier & (deg > 0)).squeeze(1)
        degs = deg[ids].long()
        row = torch.repeat_interleave(degs)             # slot -> frontier row
        start = torch.cumsum(degs, 0) - degs
        pos = torch.arange(row.numel(), device=dist.device) - start[row]
        reached = torch.zeros(nv, dtype=torch.bool, device=dist.device)
        reached[dst[row_ptr[ids][row] + pos]] = True
        return reached & (dist < 0)

    def dense_sweep(dist):
        if g.has_ell_layout:
            return _pull_bfs_sweep(g, dist)[0]
        reached = torch.zeros(nv, dtype=torch.int32, device=dist.device)
        reached.scatter_reduce_(0, dst, (dist[src] >= 0).int(), "amax")
        return (reached > 0) & (dist < 0)

    while bool(frontier.any()):
        front_edges = int(torch.where(frontier, deg, 0).sum())
        if front_edges <= edge_budget:
            frontier = sparse_sweep(dist, frontier)
        else:
            frontier = dense_sweep(dist)
        dist = torch.where(frontier, level + 1, dist)
        level += 1
    return dist


def bfs_host(g_host, source: int, *, device="cuda") -> np.ndarray:
    """BFS on ``device`` from a host CSRGraph. Pull (ELL) only when the
    graph is structurally symmetric: on a directed graph the row buckets
    hold out-neighbours, so pulling over them computes the wrong
    reachability; such inputs take the push scatter."""
    from graphaibench_tpu_torch.graph.transforms import is_symmetric
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    pull_ok = is_symmetric(g_host)
    dg = to_device_graph(g_host, device=device, with_transpose=False,
                         with_ell=pull_ok)
    return bfs(dg, source).cpu().numpy()
