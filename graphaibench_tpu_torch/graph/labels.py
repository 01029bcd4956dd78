"""Labeled-graph support: NLF, label reverse index, labeled motifs.

Counterpart of ``graphaibench_tpu/graph/labels.py``. The reference's mining
graph carries vertex labels with three FSM-support structures
(include/graph.h + src/common/graph.cc:1025–1120): the neighborhood label
frequency (NLF) table, per-label vertex frequency, and the label reverse
index (vertices grouped by label).

  * NLF is one SpMM, adjacency times the (nv, L) one-hot label matrix:
    kernel K1 (``ops/ell_spmm.py``) on a CUDA graph, with unit weights, so
    no (E, L) rows are materialized.
  * Labeled triangle counts are dense matrix products over label-projected
    adjacency slices, reduced in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph


def _labels_of(g: CSRGraph, labels=None) -> np.ndarray:
    lab = labels if labels is not None else g.vlabels
    if lab is None:
        raise ValueError("graph has no vertex labels")
    return np.asarray(lab, dtype=np.int32)


def num_labels(g: CSRGraph, labels=None) -> int:
    return int(_labels_of(g, labels).max()) + 1


def label_frequency(g: CSRGraph, labels=None) -> np.ndarray:
    """(L,) count of vertices per label (GraphT::labels_frequency)."""
    lab = _labels_of(g, labels)
    return np.bincount(lab, minlength=int(lab.max()) + 1).astype(np.int64)


def label_index(g: CSRGraph, labels=None) -> dict[int, np.ndarray]:
    """label -> sorted vertex ids (the reverse index, graph.cc:1080-1100)."""
    lab = _labels_of(g, labels)
    order = np.argsort(lab, kind="stable")
    sorted_lab = lab[order]
    bounds = np.searchsorted(sorted_lab, np.arange(int(lab.max()) + 2))
    return {l: order[bounds[l]:bounds[l + 1]]
            for l in range(int(lab.max()) + 1)
            if bounds[l + 1] > bounds[l]}


def neighborhood_label_frequency(g: CSRGraph, labels=None,
                                 device="cuda") -> np.ndarray:
    """(nv, L) int32 NLF table: entry (v, l) = #neighbors of v with label l.

    On ``device`` one SpMM of the graph's ELL buckets with unit weights
    against the (nv, L) float32 one-hot label matrix: K1 on a CUDA device,
    its plain version on the CPU. Counts below 2^24 are exact in float32.
    ``device=False`` takes the host route (``np.add.at``), as JAX's
    ``device=False`` does; the reference builds per-vertex hash maps
    (GraphT::computeLabelsFrequency)."""
    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    if device is not False and g.ne > 0:
        from graphaibench_tpu_torch.ops.device_graph import to_device_graph
        from graphaibench_tpu_torch.ops.spmm import spmm

        dg = to_device_graph(g, device=device, with_transpose=False)
        onehot = torch.zeros((g.nv, L), dtype=torch.float32, device=device)
        onehot[torch.arange(g.nv, device=device),
               torch.from_numpy(lab.astype(np.int64)).to(device)] = 1.0
        w = torch.ones(g.ne, dtype=torch.float32, device=device)
        with torch.no_grad():
            nlf = spmm(dg, w, onehot, impl="ell")
        return nlf.to(torch.int32).cpu().numpy()
    nlf = np.zeros((g.nv, L), dtype=np.int32)
    np.add.at(nlf, g.edge_sources(), np.eye(L, dtype=np.int32)[lab[g.col_idx]])
    return nlf


def nlf_match(nlf_g: np.ndarray, nlf_p: np.ndarray) -> np.ndarray:
    """FSM/subgraph-matching pruning filter: graph vertex v can host
    pattern vertex u only if NLF_g[v] >= NLF_p[u] elementwise.
    Returns a (nv, np) boolean candidate matrix."""
    L = max(nlf_g.shape[1], nlf_p.shape[1])
    a = np.zeros((nlf_g.shape[0], L), np.int32)
    a[:, : nlf_g.shape[1]] = nlf_g
    b = np.zeros((nlf_p.shape[0], L), np.int32)
    b[:, : nlf_p.shape[1]] = nlf_p
    return (a[:, None, :] >= b[None, :, :]).all(-1)


def labeled_triangle_counts(g: CSRGraph, labels=None, *,
                            device="cuda") -> dict:
    """Exact triangle counts per unordered label triple {la, lb, lc}.

    Project the dense adjacency onto per-label column slices and contract:
    sum over (la<=lb<=lc) of tr(A[la,lb] @ A[lb,lc] @ A[lc,la]) with
    multiplicity handling. The products run in float32 on 0/1 operands
    (exact integers), each trace is reduced in float64."""
    from graphaibench_tpu_torch.ops.device_graph import dense_adjacency
    from graphaibench_tpu_torch.ops.math import full_float32_matmul

    lab = _labels_of(g, labels)
    L = int(lab.max()) + 1
    A = dense_adjacency(g, device=device)
    masks = [torch.from_numpy((lab == l).astype(np.float32)).to(device)
             for l in range(L)]

    def proj(p, q):  # A restricted to label-p rows / label-q columns
        return A * masks[p][:, None] * masks[q][None, :]

    out = {}
    with full_float32_matmul():
        for la in range(L):
            for lb in range(la, L):
                ab = proj(la, lb)
                for lc in range(lb, L):
                    # ordered closed walks u(la) -> v(lb) -> w(lc) -> u:
                    # tr(A_ab A_bc A_ca) = sum(A_ab * (A_bc @ A_ca)^T)
                    tri = float(torch.sum(ab * (proj(lb, lc) @ proj(lc, la)).T,
                                          dtype=torch.float64))
                    # one unordered triangle is counted once per vertex
                    # ordering consistent with the label multiset
                    div = {3: 1.0, 2: 2.0, 1: 6.0}[len({la, lb, lc})]
                    cnt = int(round(tri / div))
                    if cnt:
                        out[(la, lb, lc)] = cnt
    return out
