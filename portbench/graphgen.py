"""The benchmark's own R-MAT graph, made from a configuration's ``graph`` entry.

The draws are a frozen copy of the port's ``graph/generators.py::rmat``:
the same ``numpy.random.default_rng(seed)`` draws bit for bit. The clean-up
is the port's with ``undirected=True`` (self-loops dropped, each edge added
in both directions, duplicates removed, rows and their neighbours sorted),
run as one sort of 64-bit keys with ``torch.unique``, on the card when there
is one, where the port's host ``np.unique(axis=0)`` takes minutes at the
products shape.

R-MAT's ids run to a power of two. A graph with a published vertex and edge
count (``num_nodes``, ``num_edges_undirected`` in the entry) keeps the draws
whose two ends are below ``num_nodes``, and of their distinct undirected
pairs the first ``num_edges_undirected`` in the order drawn, as if drawing
stopped there. The graph is a fixed part of a configuration, like a dataset:
its seed is the configuration's, never the run's.

A made graph is kept in ``portbench/cache/graphs/`` (a fixed directory of
the checkout, kept out of git) as one ``.npz`` of ``row_ptr`` (int64) and
``col_idx`` (int32), so that only a checkout's first run makes it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

CACHE_DIR = Path(__file__).resolve().parent / "cache" / "graphs"


def rmat_draws(scale: int, edge_factor: int, seed: int, a: float, b: float,
               c: float) -> tuple[np.ndarray, np.ndarray]:
    """The raw (src, dst) int64 edge list of the port's ``rmat``: one
    quadrant choice per bit of the ids, two uniform draws per edge and bit."""
    nv = 1 << scale
    ne = nv * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(ne, dtype=np.int64)
    dst = np.zeros(ne, dtype=np.int64)
    for bit in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        go_right_src = r1 > (a + b)
        p_right = np.where(go_right_src, c / (c + (1 - a - b - c)), b / (a + b))
        go_right_dst = r2 > (1 - p_right)
        src |= go_right_src.astype(np.int64) << bit
        dst |= go_right_dst.astype(np.int64) << bit
    return src, dst


def first_pairs(s: torch.Tensor, d: torch.Tensor, nv: int,
                pairs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``pairs`` distinct undirected pairs of the edges (s, d), in
    the order drawn, as (lo, hi) with lo < hi."""
    keys = torch.minimum(s, d) * nv + torch.maximum(s, d)
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    if uniq.numel() < pairs:
        raise ValueError(f"the draws hold {uniq.numel()} distinct pairs, "
                         f"fewer than the {pairs} asked for")
    first = torch.full_like(uniq, keys.numel()).scatter_reduce_(
        0, inv, torch.arange(keys.numel(), device=keys.device), "amin")
    chosen = uniq[torch.argsort(first)[:pairs]]
    lo = chosen // nv
    return lo, chosen - lo * nv


def undirected_csr(src: np.ndarray, dst: np.ndarray, nv: int, device: str,
                   pairs: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(row_ptr int64, col_idx int32) of the undirected simple graph on the
    edges with both ends below ``nv``: no self-loops, each pair once in each
    direction, sorted; with ``pairs``, only the first that many pairs drawn."""
    s = torch.from_numpy(src).to(device)
    d = torch.from_numpy(dst).to(device)
    keep = (s != d) & (s < nv) & (d < nv)
    s, d = s[keep], d[keep]
    del keep
    if pairs is not None:
        s, d = first_pairs(s, d, nv, pairs)
    keys = torch.cat([s * nv + d, d * nv + s])
    del s, d
    keys = torch.unique(keys, sorted=True)
    rows = keys // nv
    col = (keys - rows * nv).to(torch.int32)
    counts = torch.bincount(rows, minlength=nv)
    row_ptr = torch.zeros(nv + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return row_ptr.cpu().numpy(), col.cpu().numpy()


def cache_path(spec: dict) -> Path:
    key = (f"rmat_s{spec['scale']}_ef{spec['edge_factor']}_seed{spec['seed']}_"
           f"a{spec['a']}_b{spec['b']}_c{spec['c']}_und")
    if "num_nodes" in spec:
        key += f"_nv{spec['num_nodes']}_pairs{spec['num_edges_undirected']}"
    return CACHE_DIR / f"{key}.npz"


def make_graph(spec: dict, device: str) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's graph as (row_ptr, col_idx), from the cache or
    made (and then cached)."""
    if spec.get("generator") != "rmat":
        raise ValueError(f"unknown graph generator {spec.get('generator')!r}")
    path = cache_path(spec)
    if path.exists():
        with np.load(path) as z:
            return z["row_ptr"], z["col_idx"]
    src, dst = rmat_draws(spec["scale"], spec["edge_factor"], spec["seed"],
                          spec["a"], spec["b"], spec["c"])
    row_ptr, col_idx = undirected_csr(
        src, dst, spec.get("num_nodes", 1 << spec["scale"]), device,
        spec.get("num_edges_undirected"))
    del src, dst
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, row_ptr=row_ptr, col_idx=col_idx)
    os.replace(tmp, path)
    return row_ptr, col_idx
