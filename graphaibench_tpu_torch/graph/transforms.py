"""Pure-function graph transforms.

The port's own copy of the part of ``graphaibench_tpu/graph/transforms.py``
that it calls (same names, same arrays bit for bit). Each function mirrors
a mutating method of the reference graph classes but returns a fresh
:class:`CSRGraph`:

  add_selfloop        — lgraph.h:185-218
  symmetrize          — graph.cc:397 (Converter symmetrization)
  sort_and_clean      — graph.cc:237-280 (sort, dedup, strip selfloops)
  gcn_vertex_norms    — lgraph.cpp:22-34 (1/sqrt(deg))
  gcn_edge_norms      — lgraph.cpp:6-20 (1/sqrt(d_i d_j))
  sage_edge_norms     — sage_aggregator.cpp:14-28 (1/deg)

The reorderings, subgraphs and the orientation of the JAX package's
module come with the slices that need them.
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
