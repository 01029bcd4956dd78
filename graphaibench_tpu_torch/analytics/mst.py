"""Minimum spanning forest: Boruvka rounds with dense scatter-min.

Counterpart of ``graphaibench_tpu/analytics/mst.py``: each round every
component picks its lightest outgoing edge with one scatter-min over the
edge list (ties broken by a rank of the undirected edges built on the host),
the chosen edges join the forest, and components merge by min-label
propagation. Plain PyTorch (``scatter_reduce_`` amin) on the graph's device;
the rounds are a Python loop that reads one flag a round and stops, as JAX's
``while_loop``, when no label changed or after nv rounds. The edge ids and
the total equal JAX's. ``kruskal_oracle`` is a copy of JAX's serial
verifier.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.ops.device_graph import to_device_graph

INT32_MAX = np.iinfo(np.int32).max


def _pair_ids(g: CSRGraph, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """lo * nv + hi of each edge: in the order of the (lo, hi) rows that
    JAX's ``np.unique(..., axis=0)`` sorts, as one int64 key, which
    ``np.unique`` sorts many times faster."""
    return (np.minimum(src, dst).astype(np.int64) * g.nv
            + np.maximum(src, dst).astype(np.int64))


def _pair_keys(g: CSRGraph, weights: np.ndarray) -> np.ndarray:
    """Symmetric tie-free keys: the rank of each UNDIRECTED edge by (weight,
    lo, hi), so both directions of an edge share one key and equal weights
    still order strictly; Boruvka's no-cycle argument then holds exactly."""
    s_np, d_np = g.coo()
    pair_ids, inverse = np.unique(_pair_ids(g, s_np, d_np),
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    w_np = np.asarray(weights, dtype=np.float64)
    pair_w = np.full(len(pair_ids), np.inf)
    np.minimum.at(pair_w, inverse, w_np)
    pair_rank = np.zeros(len(pair_ids), dtype=np.int32)
    pair_rank[np.argsort(pair_w, kind="stable")] = np.arange(
        len(pair_ids), dtype=np.int32)
    return pair_rank[inverse]


def boruvka_mst(g: CSRGraph, weights: np.ndarray, *, device="cuda"):
    """Returns (edge_ids, total_weight): indices into g's CSR edge order
    forming a minimum spanning forest. ``g`` must be symmetric; each
    undirected edge may be reported via either direction."""
    nv, ne = g.nv, g.ne
    if ne == 0:
        return np.zeros(0, dtype=np.int64), 0.0
    dg = to_device_graph(g, device=device, with_transpose=False,
                         with_ell=False)
    src, dst = dg.edge_src.long(), dg.col_idx.long()
    key = torch.from_numpy(_pair_keys(g, weights)).to(device)
    inf = torch.tensor(INT32_MAX, dtype=torch.int32, device=device)
    eid = torch.arange(ne, device=device)
    comp = torch.arange(nv, dtype=torch.int64, device=device)
    in_mst = torch.zeros(ne, dtype=torch.bool, device=device)
    it = 0
    changed = True
    while changed and it < nv:
        cu, cv = comp[src], comp[dst]
        cross = cu != cv
        k = torch.where(cross, key, inf)
        # the lightest outgoing edge of each component
        best = torch.full((nv,), INT32_MAX, dtype=torch.int32, device=device)
        best.scatter_reduce_(0, cu, k, "amin")
        picked = cross & (k == best[cu]) & (best[cu] != inf)
        in_mst[eid[picked]] = True
        # hook each component to the smaller label across picked edges
        low = torch.where(picked, torch.minimum(cu, cv),
                          torch.full_like(cu, nv))
        lab = torch.full((nv,), nv, dtype=torch.int64, device=device)
        lab.scatter_reduce_(0, cu, low, "amin")
        new_comp = torch.where(lab < nv, torch.minimum(comp, lab[comp]), comp)
        # and the other endpoint's component
        lab2 = torch.full((nv,), nv, dtype=torch.int64, device=device)
        lab2.scatter_reduce_(0, cv, low, "amin")
        l2 = lab2[new_comp]
        new_comp = torch.where(l2 < nv, torch.minimum(new_comp, l2), new_comp)
        for _ in range(2):  # pointer jumping compression
            new_comp = new_comp[new_comp]
        changed = bool((new_comp != comp).any())
        comp = new_comp
        it += 1
    ids = np.nonzero(in_mst.cpu().numpy())[0]
    # deduplicate reverse twins: keep each undirected edge once
    s_np, d_np = g.coo()
    _, uniq = np.unique(_pair_ids(g, s_np[ids], d_np[ids]),
                        return_index=True)
    ids = ids[np.sort(uniq)]
    total = float(np.asarray(weights)[ids].sum())
    return ids, total


def kruskal_oracle(g: CSRGraph, weights: np.ndarray) -> float:
    """Serial Kruskal total weight (union-find) — the verifier."""
    src, dst = g.coo()
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pairs = np.stack([lo.astype(np.int64), hi.astype(np.int64)], 1)
    _, uniq = np.unique(pairs, axis=0, return_index=True)
    order = uniq[np.argsort(weights[uniq], kind="stable")]
    parent = np.arange(g.nv)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    total = 0.0
    for e in order:
        a, b = find(src[e]), find(dst[e])
        if a != b:
            parent[a] = b
            total += float(weights[e])
    return total
