"""Betweenness centrality: Brandes with dense level-synchronous phases.

Counterpart of ``graphaibench_tpu/analytics/bc.py``. The reference's
BCSolver (src/centrality/omp_base.cc:8-110) runs a parallel BFS recording
depths and path counts, then a backward dependency accumulation over depth
buckets with bitmap successors. Here both phases are dense sweeps, depths in
place of buckets and masks in place of bitmaps: on a graph with ELL buckets
(a symmetric graph) each sweep is one pull, the kernel ``neighbor_reduce``
(``ops/ell_pull.py``) as a float32 sum; without them a push, an
``index_add_`` over the (ne,) edge list. Each ``lax.while_loop`` of the JAX
module is a Python loop that reads its flag once a level. ``sigma`` and
``delta`` are float32, as in JAX.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.segment import neighbor_reduce


def bc_single_source(g: DeviceGraph, source: int) -> torch.Tensor:
    """Dependency contributions of one source (Brandes), float32."""
    nv, dev = g.nv, g.deg.device
    src, dst = g.edge_src.long(), g.col_idx.long()
    pull = g.has_ell_layout

    def segment_sum(vals, seg):
        return torch.zeros(nv, device=dev).index_add_(0, seg, vals)

    # ---- forward: depths + shortest-path counts -------------------------
    # pull: reach[v] = sum of sigma over the frontier neighbours (symmetric
    # graph) instead of an (ne,)-scatter-add
    dist = torch.full((nv,), -1, dtype=torch.int32, device=dev)
    dist[source] = 0
    sigma = torch.zeros(nv, device=dev)
    sigma[source] = 1.0
    frontier = torch.zeros(nv, dtype=torch.bool, device=dev)
    frontier[source] = True
    lvl = 0
    while bool(frontier.any()):
        if pull:
            reach = neighbor_reduce(g, torch.where(frontier, sigma, 0.0), "sum")
        else:
            reach = segment_sum(torch.where(frontier[src], sigma[src], 0.0),
                                dst)
        frontier = (reach > 0) & (dist < 0)
        sigma = torch.where(frontier, reach, sigma)
        dist = torch.where(frontier, lvl + 1, dist)
        lvl += 1

    # ---- backward: delta accumulation level by level --------------------
    # the forward loop overshoots by one empty level (its last sweep
    # discovers nothing), so start at lvl - 1: the deepest level that has
    # vertices
    delta = torch.zeros(nv, device=dev)
    for lvl in range(lvl - 1, 0, -1):
        if pull:
            # add[u] = sigma[u] * sum over v in N(u) with dist[v] == lvl of
            # (1 + delta[v]) / sigma[v]: the neighbour's condition folds
            # into the pulled value, the row's applies after
            val = torch.where((dist == lvl) & (sigma > 0),
                              (1.0 + delta) / torch.where(sigma > 0, sigma, 1.0),
                              0.0)
            acc = neighbor_reduce(g, val, "sum")
            delta = delta + torch.where(dist == lvl - 1, sigma * acc, 0.0)
            continue
        # edges u -> v with dist[v] == dist[u] + 1 and dist[u] == lvl - 1
        on_level = (dist[src] == lvl - 1) & (dist[dst] == lvl)
        w = torch.where(
            on_level & (sigma[dst] > 0),
            sigma[src] / torch.where(sigma[dst] > 0, sigma[dst], 1.0)
            * (1.0 + delta[dst]),
            0.0)
        delta = delta + segment_sum(w, src)
    delta[source] = 0.0
    return delta


def betweenness_centrality(g: DeviceGraph, sources) -> torch.Tensor:
    """Accumulated BC over the given source set."""
    bc = torch.zeros(g.nv, device=g.deg.device)
    for s in sources:
        bc = bc + bc_single_source(g, int(s))
    return bc
