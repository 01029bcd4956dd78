"""Pattern descriptors + motif counting (reference M8).

Counterpart of ``graphaibench_tpu/analytics/motif.py``. The reference ships
a ``Pattern`` support class (src/common/pattern.cc:4–27 names 3/4-vertex
patterns from (n, m, max_degree): wedge, triangle, 3-star, 4-path,
tailed_triangle, square, diamond, 4-clique) but no benchmark on top of it;
here the descriptor comes with a solver: exact 3-motif and 4-motif counts.

Every 4-vertex motif count is a closed-form expression in dense-adjacency
products (A², and the Gram CᵀC of per-edge common-neighborhood
indicators), run as ``torch.matmul`` on the device. Counts are of
*non-induced* subgraphs (each vertex subset counted once per embedding up
to automorphism), with an induced conversion; both are held to a
brute-force enumeration oracle in the tests.

Exactness: the products' operands are 0/1 and their entries integers no
larger than the vertex or edge count, exact in float32 (GEMMs at full
float32, no TF32). Every reduction to a count (the sums of A2∘A, A2∘A2,
A∘D) runs in float64, where JAX's float32 sums round above 2^24; on
dense graphs of a few hundred vertices the two differ (PERF.md, stated
differences).

Graphs up to a few tens of thousands of vertices fit the dense path (n²
floats on the device); triangle and wedge counts also work at any scale
through ``tc.triangle_count``.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges

# canonical edge lists of the named patterns (vertices 0..n-1)
_PATTERN_EDGES = {
    "wedge": [(0, 1), (0, 2)],
    "triangle": [(0, 1), (0, 2), (1, 2)],
    "3-star": [(0, 1), (0, 2), (0, 3)],
    "4-path": [(0, 1), (1, 2), (2, 3)],
    "tailed_triangle": [(0, 1), (0, 2), (1, 2), (2, 3)],
    "square": [(0, 1), (1, 2), (2, 3), (0, 3)],
    "diamond": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3)],
    "4-clique": [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
}


@dataclasses.dataclass(frozen=True)
class Pattern:
    """A small connected pattern graph, named with the reference's
    taxonomy (pattern.cc:4–27: classify by vertex count n, edge count m
    and max degree)."""

    edges: tuple  # tuple[tuple[int, int], ...] undirected, deduped
    num_vertex_classes: int = 0

    @classmethod
    def from_name(cls, name: str) -> "Pattern":
        if name not in _PATTERN_EDGES:
            raise ValueError(f"unknown pattern {name!r}; known: "
                             f"{sorted(_PATTERN_EDGES)}")
        return cls(edges=tuple(_PATTERN_EDGES[name]))

    @classmethod
    def from_edges(cls, edges) -> "Pattern":
        es = {(min(u, v), max(u, v)) for u, v in edges if u != v}
        return cls(edges=tuple(sorted(es)))

    @property
    def n(self) -> int:
        return 1 + max(max(e) for e in self.edges)

    @property
    def m(self) -> int:
        return len(self.edges)

    @property
    def max_degree(self) -> int:
        deg = np.zeros(self.n, dtype=np.int64)
        for u, v in self.edges:
            deg[u] += 1
            deg[v] += 1
        return int(deg.max())

    @property
    def name(self) -> str:
        """Reference naming rule (pattern.cc:4–27)."""
        n, m, md = self.n, self.m, self.max_degree
        base = "unknown"
        if n == 3:
            base = "wedge" if m == 2 else "triangle"
        elif n == 4:
            if m == 3:
                base = "3-star" if md == 3 else "4-path"
            elif m == 4:
                base = "tailed_triangle" if md == 3 else "square"
            elif m == 5:
                base = "diamond"
            elif m == 6:
                base = "4-clique"
        if self.num_vertex_classes > 0:
            return f"{self.num_vertex_classes}labeled-{base}"
        return base

    def is_clique(self) -> bool:
        return self.m == self.n * (self.n - 1) // 2

    def to_graph(self) -> CSRGraph:
        src = np.array([e[0] for e in self.edges] + [e[1] for e in self.edges])
        dst = np.array([e[1] for e in self.edges] + [e[0] for e in self.edges])
        return from_edges(src, dst, self.n)


def motif_counts(g: CSRGraph, k: int, *, edge_chunk: int = 4096,
                 device="cuda") -> dict:
    """Exact non-induced counts of all connected k-vertex motifs.

    k=3: wedge, triangle. k=4 adds 3-star, 4-path, tailed_triangle,
    square (C4), diamond, 4-clique. The heavy terms are dense products on
    ``device``:

      A2 = A @ A                      (common-neighbor counts)
      tri_e = A2 ∘ A                  (triangles through each edge)
      24·K4 = Σ A ∘ (CᵀC),  C rows = a_u ∘ a_v per directed edge

    with CᵀC summed over ``edge_chunk`` edges at a time, so that the
    (chunk, n) row gathers stay bounded. Every sum to a count is float64.
    """
    from graphaibench_tpu_torch.ops.device_graph import (
        dense_adjacency,
        undirected_pairs,
    )
    from graphaibench_tpu_torch.ops.math import full_float32_matmul

    if k not in (3, 4):
        raise ValueError("only 3- and 4-vertex motifs are supported")
    n = g.nv
    src, dst = undirected_pairs(g)
    deg = (np.bincount(src, minlength=n)
           + np.bincount(dst, minlength=n)).astype(np.float64)
    m = float(deg.sum() / 2)

    A = dense_adjacency(g, device=device, pairs=(src, dst))
    f64 = torch.float64
    with full_float32_matmul():
        A2 = A @ A
    tri_e = A2 * A                                   # (n, n)
    t_total = float(torch.sum(tri_e, dtype=f64)) / 6.0     # triangles
    # closed-form degree terms on host (f64 for exact big counts);
    # non-induced wedge = any two edges sharing a vertex
    wedges = float((deg * (deg - 1) / 2).sum())
    out = {"wedge": wedges, "triangle": t_total}
    if k == 3:
        return {kk: int(round(v)) for kk, v in out.items()}

    tri_v = torch.sum(tri_e, dim=1, dtype=f64).cpu().numpy() / 2.0
    # 3-star: choose 3 neighbors of a center
    star3 = (deg * (deg - 1) * (deg - 2) / 6).sum()
    # 4-path: Σ_edges (d_u-1)(d_v-1) − 3·triangles
    p4 = ((deg[src] - 1) * (deg[dst] - 1)).sum() - 3 * t_total
    # tailed triangle: a triangle vertex with a pendant edge
    tailed = (tri_v * (deg - 2)).sum()
    # square (C4): closed 4-walks minus degenerate ones; tr(A⁴) = Σ A2∘A2,
    # whose terms pass 2^24, so squared and summed in float64
    a2 = A2.reshape(-1).to(f64)
    closed4 = float(torch.dot(a2, a2))
    del a2
    c4 = (closed4 - 2 * m - 2 * float((deg * (deg - 1)).sum())) / 8.0
    # diamond: two triangles sharing the chord edge (u,v)
    s_dev = torch.from_numpy(src).to(device)
    d_dev = torch.from_numpy(dst).to(device)
    te = tri_e[s_dev, d_dev].to(f64)
    diamond = float((te * (te - 1) / 2).sum())
    del tri_e, A2
    # 4-clique: Σ_{(u,v)∈E} edges within N(u)∩N(v) = 6·K4, via the Gram
    # matrix of per-edge common-neighborhood indicators c_e = a_u ∘ a_v:
    # Σ_{directed e} c_e c_eᵀ = CᵀC and 24·K4 = Σ A ∘ CᵀC. D's entries are
    # at most the directed edge count, exact in float32.
    dsrc = torch.cat([s_dev, d_dev])
    ddst = torch.cat([d_dev, s_dev])
    ne_dir = len(dsrc)
    D = torch.zeros((n, n), dtype=torch.float32, device=device)
    with full_float32_matmul():
        for s in range(0, ne_dir, edge_chunk):
            e = min(s + edge_chunk, ne_dir)
            Cc = A[dsrc[s:e]] * A[ddst[s:e]]         # (chunk, n)
            D.addmm_(Cc.T, Cc)
    k4 = float(torch.sum(A * D, dtype=f64)) / 24.0
    out.update({"3-star": star3, "4-path": p4, "tailed_triangle": tailed,
                "square": c4, "diamond": diamond, "4-clique": k4})
    return {kk: int(round(v)) for kk, v in out.items()}


# linear map from non-induced to induced counts (rows: pattern, columns:
# superpattern contributions — how many non-induced copies of `row` each
# induced `col` contains, for 4-vertex patterns)
_INDUCED_ORDER = ["3-star", "4-path", "square", "tailed_triangle",
                  "diamond", "4-clique"]
_SUPER = np.array([
    # 3-star 4-path square tailed diamond 4-clique
    [1, 0, 0, 1, 2, 4],    # 3-star copies inside each
    [0, 1, 4, 2, 6, 12],   # 4-path copies
    [0, 0, 1, 0, 1, 3],    # square copies
    [0, 0, 0, 1, 4, 12],   # tailed-triangle copies
    [0, 0, 0, 0, 1, 6],    # diamond copies
    [0, 0, 0, 0, 0, 1],    # 4-clique
], dtype=np.int64)


def induced_motif_counts(g: CSRGraph, *, device="cuda") -> dict:
    """Induced 4-motif counts, by inverting the containment matrix over
    the non-induced counts (plus wedge/triangle which coincide for k=3
    only through the triangle)."""
    ni = motif_counts(g, 4, device=device)
    b = np.array([ni[p] for p in _INDUCED_ORDER], dtype=np.int64)
    x = np.linalg.solve(_SUPER.astype(np.float64), b.astype(np.float64))
    out = {p: int(round(v)) for p, v in zip(_INDUCED_ORDER, x)}
    out["triangle"] = ni["triangle"]
    out["wedge"] = ni["wedge"] - 3 * ni["triangle"]  # open wedges
    return out


def count_pattern(g: CSRGraph, pattern, *, induced: bool = False,
                  device="cuda") -> int:
    """Count occurrences of a named pattern (or Pattern object)."""
    p = Pattern.from_name(pattern) if isinstance(pattern, str) else pattern
    name = p.name
    if name not in _PATTERN_EDGES:
        raise ValueError(f"unsupported pattern {name!r}")
    k = p.n
    if induced and k == 4:
        counts = induced_motif_counts(g, device=device)
    else:
        counts = motif_counts(g, k, device=device)
        if induced and k == 3:
            # induced wedge = open wedge (triangles are already induced)
            counts = dict(counts)
            counts["wedge"] = counts["wedge"] - 3 * counts["triangle"]
    return counts[name]


def brute_force_motif_counts(g: CSRGraph, k: int) -> dict:
    """Serial enumeration oracle (tests only): classify every connected
    k-subset by its induced subgraph, then convert to non-induced."""
    from graphaibench_tpu_torch.graph.transforms import dense_adjacency

    a = dense_adjacency(g).astype(bool)
    n = g.nv
    induced = {name: 0 for name in _PATTERN_EDGES if len(set(
        v for e in _PATTERN_EDGES[name] for v in e)) == k}
    names_by_sig = {}
    for name, edges in _PATTERN_EDGES.items():
        nn = 1 + max(max(e) for e in edges)
        if nn != k:
            continue
        for perm in itertools.permutations(range(k)):
            sig = frozenset((min(perm[u], perm[v]), max(perm[u], perm[v]))
                            for u, v in edges)
            names_by_sig[sig] = name
    for sub in itertools.combinations(range(n), k):
        es = frozenset((i, j) for i, j in itertools.combinations(range(k), 2)
                       if a[sub[i], sub[j]])
        name = names_by_sig.get(es)
        if name is not None:
            induced[name] += 1
    # convert induced -> non-induced
    if k == 3:
        return {"triangle": induced["triangle"],
                "wedge": induced["wedge"] + 3 * induced["triangle"]}
    vec = np.array([induced[p] for p in _INDUCED_ORDER], dtype=np.int64)
    ni = _SUPER @ vec
    out = {p: int(c) for p, c in zip(_INDUCED_ORDER, ni)}
    # triangles/wedges from the 3-motif oracle
    out.update(brute_force_motif_counts(g, 3))
    # also expose induced counts for direct checks
    out["_induced"] = induced
    return out
