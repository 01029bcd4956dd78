"""Hierarchical agglomerative clustering.

The port's own copy of ``graphaibench_tpu/analytics/hac.py``: host
numpy, bit-equal to it (``tests/test_torch_p15b.py``).

The reference's src/clustering (1.5 kLoC heap-based + NN-chain HAC with
complete/average linkage) does not build as shipped — its parlaylib/PAM
submodules are empty (SURVEY.md B11). This is a working implementation:
Lance-Williams matrix HAC over a dense distance matrix with
complete / average / single linkage, returning a scipy-style linkage
matrix (merge_a, merge_b, dist, size)."""

from __future__ import annotations

import numpy as np


def hac(dist: np.ndarray, linkage: str = "average") -> np.ndarray:
    """O(n^2 log n)-ish matrix HAC. ``dist``: (n, n) symmetric distances.
    Returns (n-1, 4) linkage rows [a, b, d, size] with cluster ids >= n
    for merged clusters (scipy convention)."""
    n = dist.shape[0]
    d = dist.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    size = np.ones(n)
    active = np.ones(n, dtype=bool)
    ids = np.arange(n)          # current cluster id per matrix row
    out = np.zeros((n - 1, 4))
    next_id = n
    for step in range(n - 1):
        # closest active pair
        masked = np.where(active[:, None] & active[None, :], d, np.inf)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        if i > j:
            i, j = j, i
        dij = masked[i, j]
        out[step] = (min(ids[i], ids[j]), max(ids[i], ids[j]), dij,
                     size[i] + size[j])
        # Lance-Williams update into row i
        if linkage == "single":
            new = np.minimum(d[i], d[j])
        elif linkage == "complete":
            new = np.maximum(d[i], d[j])
        else:  # average (UPGMA)
            new = (size[i] * d[i] + size[j] * d[j]) / (size[i] + size[j])
        d[i], d[:, i] = new, new
        d[i, i] = np.inf
        active[j] = False
        size[i] += size[j]
        ids[i] = next_id
        next_id += 1
    return out


def hac_from_embeddings(x: np.ndarray, linkage: str = "average") -> np.ndarray:
    """Euclidean-distance HAC over row vectors (the MXU-friendly distance
    matrix build: |a-b|^2 = |a|^2 + |b|^2 - 2ab)."""
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return hac(np.sqrt(np.maximum(d2, 0.0)), linkage)


def cut_clusters(link: np.ndarray, n: int, num_clusters: int) -> np.ndarray:
    """Cut the dendrogram into ``num_clusters`` flat labels."""
    parent = np.arange(n + len(link))
    for step, (a, b, _d, _s) in enumerate(link[: n - num_clusters]):
        parent[int(a)] = n + step
        parent[int(b)] = n + step
    roots = {}
    labels = np.zeros(n, dtype=np.int32)
    for v in range(n):
        x = v
        while parent[x] != x:
            x = parent[x]
        labels[v] = roots.setdefault(x, len(roots))
    return labels
