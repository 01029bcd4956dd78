"""Connected components: min-label propagation to fixpoint, plus the
Afforest sampling shortcut.

Counterpart of ``graphaibench_tpu/analytics/cc.py``. The reference ships
Shiloach-Vishkin (omp_base.cc:5-50) and Afforest (omp_afforest.cc), both
pointer-jumping schemes. The dense formulation is label propagation, a min
over the neighbours' labels per sweep (``neighbor_reduce`` over the ELL
buckets, or a scatter-min over the edge list on a graph without them),
plus pointer-jumping compression (comp = comp[comp], twice a sweep), which
converges in O(log n) sweeps on most graphs.

:func:`connected_components_afforest` is the dense redesign of the
reference's sampling shortcut (omp_afforest.cc:28-72): link every vertex
through its first ``neighbor_rounds`` neighbours only (a dense (nv, r)
gather, no full-edge sweep), find the most frequent resulting label, the
giant intermediate component, then finish on the REMAINDER: the giant set
is contracted to one super-vertex and the ordinary fixpoint runs on the
contracted graph (freezing the giant label instead would block label flow
THROUGH the giant set). Its host phases are numpy, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.segment import neighbor_reduce


def connected_components(g: DeviceGraph, *,
                         max_iter: int | None = None) -> torch.Tensor:
    """Component labels (int32); label = min vertex id in the component.
    Assumes a symmetric (undirected) graph like the reference solvers."""
    nv = g.nv
    src, dst = g.edge_src.long(), g.col_idx.long()
    max_iter = nv if max_iter is None else max_iter
    pull = g.has_ell_layout
    comp = torch.arange(nv, dtype=torch.int32, device=g.deg.device)
    it, changed = 0, True
    while changed and it < max_iter:
        # hook: the min label over each vertex's neighbourhood
        if pull:
            cand = neighbor_reduce(g, comp, "min")
        else:
            cand = torch.full_like(comp, nv).scatter_reduce_(
                0, dst, comp[src], "amin")
        new = torch.minimum(comp, cand)
        # compress: pointer jumping
        new = new[new.long()]
        new = new[new.long()]
        changed = bool((new != comp).any())
        comp = new
        it += 1
    return comp


def _link_first_neighbors(nbr_r: torch.Tensor, deg: torch.Tensor,
                          rounds: int) -> torch.Tensor:
    """Afforest phase 1 (omp_afforest.cc:28-40): one link per vertex per
    round through its r-th neighbour, compressed to a full pointer-jump
    fixpoint after each round (Compress, omp_afforest.cc:95-103). The
    min-hook keeps the invariant comp[u] = id of a vertex CONNECTED to u
    and comp[u] <= u, so after compression the most frequent label c names
    a connected set whose minimum id is c itself."""
    comp = torch.arange(deg.shape[0], dtype=torch.int32, device=deg.device)

    def compress(c):
        while True:
            cc = c[c.long()]
            if not bool((cc != c).any()):
                return c
            c = cc

    for r in range(rounds):
        cand = torch.where(deg > r, comp[nbr_r[:, r].long()], comp)
        comp = compress(torch.minimum(comp, cand))
    return comp


def connected_components_afforest(g_host, *, neighbor_rounds: int = 2,
                                  giant_frac: float = 0.2,
                                  device="cuda") -> np.ndarray:
    """Connected components with the Afforest sampling shortcut
    (omp_afforest.cc:28-72), on ``device``. Requires a structurally
    symmetric graph (the reference's undirected branch,
    omp_afforest.cc:47-56).

    1. Device: link through the first ``neighbor_rounds`` neighbours only.
    2. Host: an exact bincount finds the giant intermediate label c.
    3. Contract {comp == c} to a super-vertex, solve the contracted graph
       with the ordinary fixpoint, expand. Local ids are assigned in
       ascending original-id order, so the contracted min-index labels ARE
       the global min-id labels.

    Falls back to the plain fixpoint when no giant component emerges
    (giant < giant_frac * nv), where contraction would buy nothing."""
    from graphaibench_tpu_torch.graph import transforms as T
    from graphaibench_tpu_torch.graph.csr import from_edges
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    nv, ne = g_host.nv, g_host.ne
    rp = np.asarray(g_host.row_ptr)
    ci = np.asarray(g_host.col_idx)
    deg = np.diff(rp)

    if nv == 0:
        return np.empty(0, np.int32)
    if ne == 0:
        # edgeless: identity labels (ci is empty, so the neighbour-table
        # gather below would index out of bounds)
        return np.arange(nv, dtype=np.int32)

    def fixpoint(g):
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=True)
        return connected_components(dg).cpu().numpy()

    # phase 1: first-k neighbour table, (nv, rounds), self-padded
    k = neighbor_rounds
    pos = rp[:-1, None] + np.arange(k)[None, :]
    valid = pos < rp[1:, None]
    nbr = np.where(valid, ci[np.minimum(pos, max(ne - 1, 0))],
                   np.arange(nv)[:, None]).astype(np.int32)
    comp1 = _link_first_neighbors(
        torch.from_numpy(nbr).to(device),
        torch.from_numpy(deg.astype(np.int32)).to(device), k).cpu().numpy()

    c = int(np.bincount(comp1, minlength=nv).argmax())
    is_c = comp1 == c
    if int(is_c.sum()) < giant_frac * nv:
        return fixpoint(g_host)

    # phase 2: contract the giant set, fixpoint on the remainder graph
    r_mask = ~is_c
    verts = np.nonzero(r_mask | (np.arange(nv) == c))[0]   # ascending ids
    local = np.empty(nv, np.int64)
    local[verts] = np.arange(len(verts))
    local[is_c] = local[c]
    edge_src = np.repeat(np.arange(nv), deg)
    keep = r_mask[edge_src]       # giant-internal edges are irrelevant;
    u_l = local[edge_src[keep]]   # giant<->R edges appear in R rows
    v_l = local[ci[keep]]         # (symmetric input)
    out = np.empty(nv, np.int32)
    if len(u_l):
        comp_l = fixpoint(T.sort_and_clean(from_edges(
            np.r_[u_l, v_l], np.r_[v_l, u_l], len(verts))))
    else:
        comp_l = np.arange(len(verts), dtype=np.int32)
    rep = verts[comp_l].astype(np.int32)   # global min-id per component
    out[verts] = rep
    out[is_c] = rep[local[c]]
    return out
