"""k-hop neighbour sampling and random walks.

Counterpart of ``graphaibench_tpu/analytics/khop.py``: parity with
src/sampling/omp_base.cc:6-45 (hops=3, fanouts {15,10,10}) plus the uniform
random walk the reference only stubs (src/embedding/README.md:50-54).

JAX pads every row to the largest degree, an (nv, max_deg) table (about
54 GB at rmat19); here a draw r in [0, deg(v)) indexes the CSR directly,
``col_idx[row_ptr[v] + r]``. The draws come from a ``torch.Generator`` on the
graph's device, not from JAX's key stream, so the two packages sample other
edges from one seed; the steps that consume the draws (``_khop_step``,
``_walk_step``) take them as arguments, so that a test can feed them JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph

DEFAULT_FANOUTS = (15, 10, 10)


@dataclasses.dataclass(frozen=True)
class WalkGraph:
    """A host CSR graph on a device, as the samplers and walkers read it."""

    row_ptr: torch.Tensor    # (nv + 1,) int64
    col_idx: torch.Tensor    # (ne,) int64
    deg: torch.Tensor        # (nv,) int64
    max_deg: int


def walk_graph(g: CSRGraph, device) -> WalkGraph:
    row_ptr = torch.from_numpy(np.asarray(g.row_ptr, np.int64)).to(device)
    col = torch.from_numpy(np.asarray(g.col_idx, np.int64)).to(device)
    deg = row_ptr[1:] - row_ptr[:-1]
    return WalkGraph(row_ptr=row_ptr, col_idx=col, deg=deg,
                     max_deg=int(deg.max()) if g.nv else 0)


def uniform_below(n: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One integer in [0, max(n, 1)) for each entry of ``n`` (int64), from
    62 random bits each."""
    bits = torch.randint(0, 2**62, n.shape, generator=generator,
                         device=n.device)
    return bits % n.clamp(min=1)


def _neighbour(wg: WalkGraph, v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The r-th neighbour of each v (r broadcast against v), and v itself
    where v has no neighbour."""
    deg = wg.deg[v]
    if wg.col_idx.numel() == 0:
        return torch.broadcast_to(v, r.shape).clone()
    pos = torch.where(deg > 0, wg.row_ptr[v] + r, torch.zeros_like(r))
    return torch.where(deg > 0, wg.col_idx[pos], v)


def _khop_step(wg: WalkGraph, frontier: torch.Tensor, r: torch.Tensor):
    """One hop from ``frontier`` (n,) with the draws ``r`` (n, fanout), each
    in [0, max(deg, 1)): the (srcs, dsts) of the hop, (n, fanout) each."""
    dsts = _neighbour(wg, frontier[:, None], r)
    return torch.broadcast_to(frontier[:, None], dsts.shape), dsts


def _walk_step(wg: WalkGraph, cur: torch.Tensor, r: torch.Tensor):
    """One step of every walk at ``cur`` with the draws ``r``."""
    return _neighbour(wg, cur, r)


def khop_sample(g: CSRGraph, seeds: np.ndarray, fanouts=DEFAULT_FANOUTS, *,
                seed: int = 0, device="cuda"):
    """Returns a list of (src, dst) int32 numpy edge arrays, one per hop.
    Vertices with degree 0 emit self-edges (filtered by the caller if
    undesired)."""
    wg = walk_graph(g, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    frontier = torch.from_numpy(np.asarray(seeds, np.int64)).to(device)
    out = []
    for fanout in fanouts:
        r = uniform_below(
            torch.broadcast_to(wg.deg[frontier][:, None],
                               (len(frontier), fanout)), gen)
        srcs, dsts = _khop_step(wg, frontier, r)
        out.append((srcs.reshape(-1).to(torch.int32).cpu().numpy(),
                    dsts.reshape(-1).to(torch.int32).cpu().numpy()))
        frontier = dsts.reshape(-1)
    return out


def random_walk(g: CSRGraph, starts: np.ndarray, walk_length: int, *,
                seed: int = 0, device="cuda") -> np.ndarray:
    """(num_walks, walk_length+1) int32 uniform random walks; walks stall at
    degree-0 vertices."""
    wg = walk_graph(g, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cur = torch.from_numpy(np.asarray(starts, np.int64)).to(device)
    walks = [cur]
    for _ in range(walk_length):
        cur = _walk_step(wg, cur, uniform_below(wg.deg[cur], gen))
        walks.append(cur)
    return torch.stack(walks, 1).to(torch.int32).cpu().numpy()
