"""Synthetic graph generators for tests and benchmarks.

The port's own copy of ``graphaibench_tpu/graph/generators.py`` (same
names, same graphs bit for bit): uniform random (Erdos-Renyi) and RMAT
(power-law, Graph500-style) and a 4-neighbour grid (the high-diameter
case). All deterministic given a seed.
"""

from __future__ import annotations

import os

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges
from graphaibench_tpu_torch.graph.transforms import sort_and_clean, symmetrize


def uniform_random(nv: int, ne: int, seed: int = 0, *, undirected: bool = True) -> CSRGraph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, size=ne, dtype=np.int64)
    dst = rng.integers(0, nv, size=ne, dtype=np.int64)
    g = from_edges(src, dst, nv)
    g = sort_and_clean(g)
    return symmetrize(g) if undirected else g


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         *, undirected: bool = True, cache: bool = None) -> CSRGraph:
    """RMAT generator (Graph500 parameters by default): power-law degree
    distribution, the skew regime the reference's warp/TWC load balancing
    targets — and the stress test for our degree-bucketed SpMM.

    Large instances are cached on disk in ``.rmat_cache/`` at the root of
    the checkout (the JAX package's cache: same key, same graph). Delete
    the directory to invalidate. ``cache=None`` auto-enables at
    scale >= 18."""
    nv = 1 << scale
    ne = nv * edge_factor
    if cache is None:
        cache = scale >= 18
    cpath = None
    if cache:
        cdir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".rmat_cache")
        key = (f"rmat_s{scale}_ef{edge_factor}_seed{seed}_"
               f"a{a}_b{b}_c{c}_{'und' if undirected else 'dir'}.npz")
        cpath = os.path.join(cdir, key)
        if os.path.exists(cpath):
            z = np.load(cpath)
            return CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"])
    rng = np.random.default_rng(seed)
    src = np.zeros(ne, dtype=np.int64)
    dst = np.zeros(ne, dtype=np.int64)
    for bit in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        go_right_src = r1 > (a + b)          # lower half of src range
        # within each half, prob of dst-right differs
        p_right = np.where(go_right_src, c / (c + (1 - a - b - c)), b / (a + b))
        go_right_dst = r2 > (1 - p_right)
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    g = from_edges(src, dst, nv)
    g = sort_and_clean(g)
    g = symmetrize(g) if undirected else g
    if cpath is not None:
        os.makedirs(os.path.dirname(cpath), exist_ok=True)
        # pid-unique tmp so concurrent generators (bench + a tool) never
        # interleave writes into one file; os.replace stays atomic
        tmp = f"{cpath}.tmp{os.getpid()}.npz"
        np.savez(tmp, row_ptr=g.row_ptr, col_idx=g.col_idx)
        os.replace(tmp, cpath)
    return g


def grid2d(side: int) -> CSRGraph:
    """side x side 4-neighbor grid, undirected."""
    idx = np.arange(side * side).reshape(side, side)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return symmetrize(from_edges(src, dst, side * side))
