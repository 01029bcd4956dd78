"""PageRank: pull iteration with the reference's exact constants (EPSILON
1e-4, kDamp 0.85, MAX_ITER 100 — common.h:73-76) and update rule
(omp_base.cc:5-46). Counterpart of ``graphaibench_tpu/analytics/pr.py``:
each iteration is one ``neighbor_reduce`` sum over the reverse graph's
buckets, or a scatter-add over its edge list on a graph without them. The
loop reads the error once an iteration (one host sync)."""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.segment import neighbor_reduce

EPSILON = 1e-4
K_DAMP = 0.85
MAX_ITER = 100


def pagerank(g: DeviceGraph, rg: DeviceGraph | None = None, *,
             damp: float = K_DAMP, epsilon: float = EPSILON,
             max_iter: int = MAX_ITER) -> tuple[torch.Tensor, int]:
    """Returns (float32 scores, iterations). ``rg`` is the reverse
    (incoming) graph; for symmetric graphs pass None to reuse ``g``. The
    out-degrees come from ``g``. Stops once the L1 change over all vertices
    falls below ``epsilon``, or after ``max_iter`` iterations."""
    if rg is None:
        rg = g
    nv = g.nv
    base = (1.0 - damp) / nv
    out_deg = torch.clamp(g.deg, min=1).float()
    # reverse-graph edge (v -> u) means original (u -> v): v accumulates
    rsrc, rdst = rg.edge_src.long(), rg.col_idx.long()
    pull = rg.has_ell_layout
    scores = torch.full((nv,), 1.0 / nv, dtype=torch.float32,
                        device=g.deg.device)
    err, it = float("inf"), 0
    while err >= epsilon and it < max_iter:
        contrib = scores / out_deg
        if pull:
            incoming = neighbor_reduce(rg, contrib, "sum")
        else:
            incoming = torch.zeros_like(contrib).index_add_(
                0, rsrc, contrib[rdst])
        new = base + damp * incoming
        err = float(torch.abs(new - scores).sum())
        scores = new
        it += 1
    return scores, it
