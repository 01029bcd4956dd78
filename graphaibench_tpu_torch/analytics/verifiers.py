"""Serial numpy oracles — the reference's paired-verifier pattern (every
parallel kernel ships with a serial oracle; src/traversal/verifier.cc,
src/link_analysis/verifier.cc, ...) as reusable functions for both pytest
and the CLI's Correct/Wrong print.

The port's own copy of ``graphaibench_tpu/analytics/verifiers.py`` (same
names, same results), without ``kcore_serial``, which comes with the k-core
solver (ROADMAP P12b).
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph


def bfs_serial(g: CSRGraph, source: int) -> np.ndarray:
    """Serial BFS depths, -1 for unreachable (verifier.cc:6-40)."""
    dist = np.full(g.nv, -1, dtype=np.int32)
    dist[source] = 0
    q = deque([source])
    while q:
        u = q.popleft()
        for v in g.neighbors(u):
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                q.append(int(v))
    return dist


def dijkstra_serial(g: CSRGraph, weights: np.ndarray, source: int) -> np.ndarray:
    """Serial Dijkstra (verifier.cc:42-85). ``weights`` per edge in CSR
    order; inf for unreachable."""
    dist = np.full(g.nv, np.inf)
    dist[source] = 0.0
    pq = [(0.0, source)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        b, e = g.row_ptr[u], g.row_ptr[u + 1]
        for i in range(b, e):
            v = g.col_idx[i]
            nd = d + weights[i]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, int(v)))
    return dist


def triangle_count_serial(g_dag: CSRGraph) -> int:
    """Sum over DAG edges of |N(u) ∩ N(v)| (omp_base.cc:5-26)."""
    total = 0
    src, dst = g_dag.coo()
    for u, v in zip(src, dst):
        nu = g_dag.neighbors(u)
        nv_ = g_dag.neighbors(v)
        total += len(np.intersect1d(nu, nv_, assume_unique=True))
    return total


def pagerank_serial(g: CSRGraph, rg: CSRGraph, damp=0.85, epsilon=1e-4,
                    max_iter=100) -> np.ndarray:
    """Serial pull PageRank matching omp_base.cc:5-46 exactly."""
    nv = g.nv
    scores = np.full(nv, 1.0 / nv, dtype=np.float64)
    base = (1.0 - damp) / nv
    for _ in range(max_iter):
        contrib = scores / g.degrees().clip(1)
        new = np.zeros(nv)
        rsrc, rdst = rg.coo()
        np.add.at(new, rsrc, contrib[rdst])
        new = base + damp * new
        err = np.abs(new - scores).sum()
        scores = new
        if err < epsilon:
            break
    return scores


def cc_serial(g: CSRGraph) -> np.ndarray:
    """Component ids via BFS sweep; id = min vertex of the component."""
    comp = np.full(g.nv, -1, dtype=np.int64)
    for s in range(g.nv):
        if comp[s] >= 0:
            continue
        comp[s] = s
        q = deque([s])
        while q:
            u = q.popleft()
            for v in g.neighbors(u):
                if comp[v] < 0:
                    comp[v] = s
                    q.append(int(v))
    return comp


def bc_serial(g: CSRGraph, sources) -> np.ndarray:
    """Brandes betweenness from the given sources (serial oracle for
    src/centrality)."""
    bc = np.zeros(g.nv)
    for s in sources:
        dist = np.full(g.nv, -1, dtype=np.int64)
        sigma = np.zeros(g.nv)
        dist[s] = 0
        sigma[s] = 1.0
        order = [s]
        q = deque([s])
        while q:
            u = q.popleft()
            for v in g.neighbors(u):
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(int(v))
                    order.append(int(v))
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
        delta = np.zeros(g.nv)
        for u in reversed(order):
            for v in g.neighbors(u):
                if dist[v] == dist[u] + 1 and sigma[v] > 0:
                    delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
            if u != s:
                bc[u] += delta[u]
    return bc


def coloring_valid(g: CSRGraph, colors: np.ndarray) -> bool:
    src, dst = g.coo()
    self_edges = src == dst
    return bool(np.all((colors[src] != colors[dst]) | self_edges))


def cf_rmse(g: CSRGraph, ratings: np.ndarray, latents: np.ndarray) -> float:
    src, dst = g.coo()
    est = np.einsum("ek,ek->e", latents[src], latents[dst])
    return float(np.sqrt(np.sum((ratings - est) ** 2) / g.ne))
