"""Link prediction: Jaccard / common-neighbor / Adamic-Adar scores.

The port's own copy of ``graphaibench_tpu/analytics/linkpred.py``: host
numpy, bit-equal to it (``tests/test_torch_p15b.py``).

The reference's src/link_prediction is README-only ("jaccard"). Real
implementation: batched sorted-list intersections (the TC machinery) for
candidate pairs, plus all-pairs top-k prediction for small graphs."""

from __future__ import annotations

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph


def _intersection_sizes(g: CSRGraph, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    out = np.zeros(len(u), dtype=np.int64)
    for i, (a, b) in enumerate(zip(u, v)):
        out[i] = len(np.intersect1d(g.neighbors(a), g.neighbors(b),
                                    assume_unique=True))
    return out


def jaccard(g: CSRGraph, pairs: np.ndarray) -> np.ndarray:
    """Jaccard coefficient |N(u) ∩ N(v)| / |N(u) ∪ N(v)| per (u, v) row."""
    u, v = pairs[:, 0], pairs[:, 1]
    inter = _intersection_sizes(g, u, v)
    deg = g.degrees().astype(np.int64)
    union = deg[u] + deg[v] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def common_neighbors(g: CSRGraph, pairs: np.ndarray) -> np.ndarray:
    return _intersection_sizes(g, pairs[:, 0], pairs[:, 1]).astype(np.float64)


def adamic_adar(g: CSRGraph, pairs: np.ndarray) -> np.ndarray:
    deg = g.degrees().astype(np.float64)
    out = np.zeros(len(pairs))
    for i, (a, b) in enumerate(pairs):
        common = np.intersect1d(g.neighbors(a), g.neighbors(b),
                                assume_unique=True)
        d = deg[common]
        out[i] = np.sum(1.0 / np.log(np.maximum(d, 2.0)))
    return out


def predict_links(g: CSRGraph, k: int = 10, metric: str = "jaccard") -> np.ndarray:
    """Top-k non-edges by score (small graphs: dense candidate set).
    Returns (k, 3) rows [u, v, score]."""
    score_fn = {"jaccard": jaccard, "cn": common_neighbors,
                "aa": adamic_adar}[metric]
    # candidates: 2-hop pairs that are not edges
    cand = set()
    for u in range(g.nv):
        for w in g.neighbors(u):
            for v in g.neighbors(w):
                if v > u and v not in set(g.neighbors(u).tolist()):
                    cand.add((u, int(v)))
    if not cand:
        return np.zeros((0, 3))
    pairs = np.asarray(sorted(cand), dtype=np.int64)
    scores = score_fn(g, pairs)
    top = np.argsort(-scores, kind="stable")[:k]
    return np.column_stack([pairs[top], scores[top]])
