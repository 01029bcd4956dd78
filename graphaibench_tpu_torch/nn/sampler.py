"""GraphSAINT frontier sampler.

Counterpart of ``graphaibench_tpu/nn/sampler.py`` (the reference's
dashboard sampling, src/gnn/sampler.cpp:163-293, itself from GraphSAINT
ipdps19), and bit-equal to it: keep a frontier of m vertices; repeatedly
pick a frontier slot with probability proportional to its
(degree-clipped) weight, hop to a uniform random neighbor, add it to the
sample, and replace the slot. Constants match sampler.h:3-4 /
global.h:31 (SAMPLE_CLIP 3000, frontier 3000). The sampler runs on the
host: ``native.saint_sample`` where ``g++`` is available, else the numpy
route, which draws another (numpy) stream with the same distribution.
"""

from __future__ import annotations

import numpy as np

from graphaibench_tpu_torch import native
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.graph.csr import CSRGraph

SAMPLE_CLIP = 3000
DEFAULT_FRONTIER = 3000


class SaintSampler:
    def __init__(
        self,
        full_graph: CSRGraph,
        masked_graph: CSRGraph,
        train_mask: np.ndarray,
        *,
        frontier_size: int = DEFAULT_FRONTIER,
    ):
        self.full = full_graph
        self.masked = masked_graph
        self.train_nodes = np.nonzero(np.asarray(train_mask) != 0)[0]
        if len(self.train_nodes) == 0:
            raise ValueError("the train mask selects no vertex")
        self.m = frontier_size

    def select_vertices(self, n: int, seed: int) -> np.ndarray:
        """Sample ~n vertices (the reference's select_vertices: m seeds +
        n-m frontier expansions; the returned set may be smaller due to
        revisits)."""
        g = self.masked
        vs = native.saint_sample(
            g.row_ptr, g.col_idx, self.train_nodes.astype(np.int64), n,
            min(self.m, n), SAMPLE_CLIP, seed)
        if vs is not None:
            return vs
        return self.select_vertices_numpy(n, seed)

    def select_vertices_numpy(self, n: int, seed: int) -> np.ndarray:
        """The route for a host without ``g++``."""
        g = self.masked
        rng = np.random.default_rng(seed)
        m = min(self.m, n)
        deg = g.degrees()

        frontier = self.train_nodes[rng.integers(0, len(self.train_nodes), m)]
        sampled = set(frontier.tolist())
        weights = np.minimum(deg[frontier], SAMPLE_CLIP).astype(np.float64)
        for _ in range(n - m):
            total = weights.sum()
            if total <= 0:
                break
            slot = rng.choice(m, p=weights / total)
            v = frontier[slot]
            d = deg[v]
            if d > 0:
                nbrs = g.neighbors(v)
                u = int(nbrs[rng.integers(0, d)])
                sampled.add(u)
                frontier[slot] = u
                weights[slot] = min(deg[u], SAMPLE_CLIP)
            else:
                weights[slot] = 0.0
        return np.fromiter(sorted(sampled), dtype=np.int64)

    def generate_subgraph(self, n: int, seed: int):
        """Returns (subgraph, local_to_global, mask) — the masked-graph
        edges among sampled vertices, reindexed (generateSubgraph,
        sampler.cpp:137-145)."""
        vs = self.select_vertices(n, seed)
        mask = np.zeros(self.full.nv, dtype=np.uint8)
        mask[vs] = 1
        masked = T.masked_subgraph(self.masked, mask)
        sub, l2g = T.induced_subgraph(masked, vs)
        return sub, l2g, mask
