"""Pure-function graph transforms.

The port's own copy of the part of ``graphaibench_tpu/graph/transforms.py``
that it calls (same names, same arrays bit for bit). Each function mirrors
a mutating method of the reference graph classes but returns a fresh
:class:`CSRGraph`:

  add_selfloop        — lgraph.h:185-218
  symmetrize          — graph.cc:397 (Converter symmetrization)
  is_symmetric        — the gate of the pull-mode analytics solvers
  orientation         — graph.cc:615-700 (degree-ordered DAG)
  reverse             — graph.cc:511-560 (incoming-edge graph)
  sort_and_clean      — graph.cc:237-280 (sort, dedup, strip selfloops)
  gcn_vertex_norms    — lgraph.cpp:22-34 (1/sqrt(deg))
  gcn_edge_norms      — lgraph.cpp:6-20 (1/sqrt(d_i d_j))
  sage_edge_norms     — sage_aggregator.cpp:14-28 (1/deg)
  masked_subgraph     — lgraph.h:231-272 (inductive training graph)
  induced_subgraph    — sampler.cpp:69-95 (GraphSAINT reindexing)
  degree_histogram    — graph.cc:587
  k_core_decomposition — graph.cc:1126 (serial peeling, k-core's oracle)

The reorderings of the JAX package's module come with the slice that needs
them (ROADMAP P15).
"""

from __future__ import annotations

import numpy as np

from graphaibench_tpu_torch import native
from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges


def add_selfloop(g: CSRGraph) -> CSRGraph:
    """Insert one self-edge per vertex, keeping each (sorted) adjacency
    list sorted — semantics of LearningGraph::add_selfloop (lgraph.h:185)."""
    src, dst = g.coo()
    src = np.concatenate([src, np.arange(g.nv, dtype=np.int32)])
    dst = np.concatenate([dst, np.arange(g.nv, dtype=np.int32)])
    return from_edges(src, dst, g.nv)


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Make the graph undirected: add reverse edges, dedup, drop selfloops
    like the reference converter's symmetrize+clean."""
    src, dst = g.coo()
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keep = s != d
    s, d = s[keep], d[keep]
    uniq = np.unique(np.stack([s.astype(np.int64), d.astype(np.int64)], axis=1), axis=0)
    return from_edges(uniq[:, 0], uniq[:, 1], g.nv)


def is_symmetric(g: CSRGraph) -> bool:
    """True iff every edge (u, v) has its reverse (v, u). Pull-mode
    frontier kernels (neighbor_reduce over row buckets) are only valid
    on structurally symmetric graphs: the CLI uses this to gate them
    (the push scatter formulation stays correct on directed inputs)."""
    src, dst = g.coo()
    fwd = src.astype(np.int64) * g.nv + dst
    rev = dst.astype(np.int64) * g.nv + src
    return np.array_equal(np.sort(fwd), np.sort(rev))


def orientation(g: CSRGraph) -> CSRGraph:
    """Degree-ordered DAG orientation: keep edge (u, v) iff
    deg(v) > deg(u) or (deg(v) == deg(u) and v > u) — graph.cc:628-631.
    Halves the edges of an undirected graph. Rows keep their input order
    on both routes (native at 2^18 edges and more, numpy below)."""
    if g.ne >= 1 << 18:
        res = native.orientation(g.row_ptr, g.col_idx)
        if res is not None:
            return CSRGraph(row_ptr=res[0], col_idx=res[1])
    deg = g.degrees()
    src, dst = g.coo()
    keep = (deg[dst] > deg[src]) | ((deg[dst] == deg[src]) & (dst > src))
    return from_edges(src[keep], dst[keep], g.nv, sort_neighbors=False)


def reverse(g: CSRGraph) -> CSRGraph:
    """Incoming-edge (transposed) graph — graph.cc:511-560."""
    src, dst = g.coo()
    return from_edges(dst, src, g.nv, elabels=g.elabels)


def sort_and_clean(g: CSRGraph) -> CSRGraph:
    """Sort adjacency lists, remove duplicate edges and selfloops
    (GraphT sort/clean, graph.cc:237-280)."""
    src, dst = g.coo()
    keep = src != dst
    s, d = src[keep].astype(np.int64), dst[keep].astype(np.int64)
    uniq = np.unique(np.stack([s, d], axis=1), axis=0)
    return from_edges(uniq[:, 0], uniq[:, 1], g.nv)


def transpose_edge_permutation(g: CSRGraph) -> np.ndarray:
    """Permutation p such that for the transposed graph's k-th edge,
    p[k] is the corresponding edge id in g. Built once on host; replaces
    the reference's per-step cuSPARSE csr2csc (gat_aggregator.cu:88-92)
    for the GAT adjoint: scores_T = scores[p]."""
    src, dst = g.coo()
    # sort edges by (dst, src): that ordering is exactly the CSR order of
    # the transposed graph (adjacency lists sorted when g's are sorted).
    # src is CSR-expanded (nondecreasing), so a STABLE sort by dst alone
    # gives (dst, src) order — the native O(ne) counting sort does it in
    # sub-second at rmat20 where np.lexsort costs ~9.4 s.
    perm = native.stable_key_sort(dst, g.nv)
    if perm is not None:
        return perm
    return np.lexsort((src, dst)).astype(np.int32)


def masked_subgraph(g: CSRGraph, mask: np.ndarray) -> CSRGraph:
    """Keep only edges whose endpoints are both masked; vertex set and ids
    unchanged — LearningGraph::generate_masked_graph (lgraph.h:231-272)."""
    mask = np.asarray(mask).astype(bool)
    src, dst = g.coo()
    keep = mask[src] & mask[dst]
    return from_edges(src[keep], dst[keep], g.nv, sort_neighbors=False)


def induced_subgraph(g: CSRGraph, vertices: np.ndarray) -> tuple[CSRGraph, np.ndarray]:
    """Vertex-induced subgraph with local reindexing.

    Returns (subgraph, vertices) where subgraph vertex i corresponds to
    global vertex vertices[i] (sorted ascending) — the reindexSubgraph
    semantics of the GraphSAINT sampler (sampler.cpp:69-95)."""
    vs = np.unique(np.asarray(vertices, dtype=np.int64))
    remap = -np.ones(g.nv, dtype=np.int64)
    remap[vs] = np.arange(len(vs))
    src, dst = g.coo()
    keep = (remap[src] >= 0) & (remap[dst] >= 0)
    return (
        from_edges(remap[src[keep]], remap[dst[keep]], len(vs), sort_neighbors=False),
        vs.astype(np.int32),
    )


def gcn_vertex_norms(g: CSRGraph) -> np.ndarray:
    """Per-vertex 1/sqrt(deg), 0 for isolated — lgraph.cpp:22-34."""
    deg = g.degrees().astype(np.float32)
    with np.errstate(divide="ignore"):
        out = 1.0 / np.sqrt(deg)
    out[deg == 0] = 0.0
    return out.astype(np.float32)


def gcn_edge_norms(g: CSRGraph) -> np.ndarray:
    """Per-edge 1/sqrt(d_src * d_dst) — lgraph.cpp:6-20."""
    vn = gcn_vertex_norms(g)
    src, dst = g.coo()
    return (vn[src] * vn[dst]).astype(np.float32)


def sage_edge_norms(g: CSRGraph) -> np.ndarray:
    """Per-edge 1/deg(src) — the SAGE mean aggregation weights
    (sage_aggregator.cpp:14-28)."""
    deg = g.degrees().astype(np.float32)
    src, _ = g.coo()
    with np.errstate(divide="ignore"):
        w = 1.0 / deg[src]
    w[~np.isfinite(w)] = 0.0
    return w.astype(np.float32)


def degree_histogram(g: CSRGraph, num_bins: int = 0) -> np.ndarray:
    """Degree histogram (graph.cc:587)."""
    deg = g.degrees()
    return np.bincount(deg, minlength=num_bins)


def k_core_decomposition(g: CSRGraph) -> np.ndarray:
    """Coreness of every vertex via iterative peeling (serial oracle,
    graph.cc:1126 / src/coreness)."""
    deg = g.degrees().astype(np.int64)
    core = np.zeros(g.nv, dtype=np.int32)
    alive = np.ones(g.nv, dtype=bool)
    k = 0
    n_alive = g.nv
    while n_alive > 0:
        while True:
            peel = alive & (deg <= k)
            if not peel.any():
                break
            for v in np.nonzero(peel)[0]:
                alive[v] = False
                core[v] = k
                n_alive -= 1
                nbrs = g.neighbors(v)
                live_nbrs = nbrs[alive[nbrs]]
                np.subtract.at(deg, live_nbrs, 1)
        k += 1
    return core
