"""Community detection: Louvain modularity optimization.

The port's own copy of ``graphaibench_tpu/analytics/community.py``: host
numpy, bit-equal to it (``tests/test_torch_p15b.py``).

The reference's src/community is README-only (cites cuGraph). This is a
real two-phase Louvain: local moves to the neighbor community with the
best modularity gain until convergence, then graph aggregation; repeat.
Host numpy (graph shrinks geometrically, the first sweep dominates)."""

from __future__ import annotations

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph


def modularity(g: CSRGraph, comm: np.ndarray, weights=None) -> float:
    src, dst = g.coo()
    w = np.ones(g.ne) if weights is None else np.asarray(weights, np.float64)
    m2 = w.sum()  # == 2m for symmetric graphs
    inside = w[comm[src] == comm[dst]].sum() / m2
    deg_w = np.zeros(g.nv)
    np.add.at(deg_w, src, w)
    tot = np.zeros(comm.max() + 1)
    np.add.at(tot, comm, deg_w)
    return float(inside - np.sum((tot / m2) ** 2))


def _local_moves(src, dst, w, nv, max_sweeps=10):
    comm = np.arange(nv)
    deg_w = np.zeros(nv)
    np.add.at(deg_w, src, w)
    tot = deg_w.copy()          # community total degree
    m2 = w.sum()
    for _ in range(max_sweeps):
        moved = 0
        for v in range(nv):
            cv = comm[v]
            # neighbor community weights
            e = slice(*np.searchsorted(src, [v, v + 1]))
            nbr_c = comm[dst[e]]
            nbr_w = w[e]
            if len(nbr_c) == 0:
                continue
            tot[cv] -= deg_w[v]
            uniq, inv = np.unique(nbr_c, return_inverse=True)
            k_in = np.zeros(len(uniq))
            np.add.at(k_in, inv, nbr_w * (dst[e] != v))
            gain = k_in - tot[uniq] * deg_w[v] / m2
            best = int(uniq[np.argmax(gain)])
            cur_gain = gain[uniq == cv][0] if (uniq == cv).any() else 0.0
            target = best if gain.max() > cur_gain + 1e-12 else cv
            comm[v] = target
            tot[target] += deg_w[v]
            if target != cv:
                moved += 1
        if moved == 0:
            break
    return comm


def louvain(g: CSRGraph, weights=None, max_levels: int = 10):
    """Returns (labels, modularity). ``g`` symmetric."""
    src, dst = g.coo()
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    w = np.ones(g.ne) if weights is None else np.asarray(weights, np.float64)
    mapping = np.arange(g.nv)
    nv = g.nv
    for _level in range(max_levels):
        comm = _local_moves(src, dst, w, nv)
        uniq, relab = np.unique(comm, return_inverse=True)
        mapping = relab[mapping]
        if len(uniq) == nv:
            break
        # aggregate: sum weights between communities
        asrc, adst = relab[src], relab[dst]
        key = asrc * len(uniq) + adst
        uk, inv = np.unique(key, return_inverse=True)
        aw = np.zeros(len(uk))
        np.add.at(aw, inv, w)
        src, dst, w = uk // len(uniq), uk % len(uniq), aw
        nv = len(uniq)
    labels = mapping
    q = modularity(g, labels, weights)
    return labels.astype(np.int32), q
