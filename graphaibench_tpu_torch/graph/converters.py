"""Graph format converters — parity with src/converters (B13):
MatrixMarket (.mtx) and Galois binary (.gr) readers, plus the converter
pipeline operations (symmetrize, clean = sort+dedup+deselfloop, DAG
orient) writing the binary CSR dataset layout.

The port's own copy of ``graphaibench_tpu/graph/converters.py``, bit-equal
to it (``tests/test_torch_p15b.py``); ``read_gr`` is ``graph/io.py``'s.
"""

from __future__ import annotations

import numpy as np

from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges
from graphaibench_tpu_torch.graph.io import load_graph, read_gr, save_graph

__all__ = ["convert", "read_gr", "read_mtx"]


def read_mtx(path: str, *, symmetrize: bool = False) -> CSRGraph:
    """MatrixMarket coordinate format; 1-based indices. The
    %%MatrixMarket header's 'symmetric' qualifier triggers mirroring."""
    sym = symmetrize
    src, dst, vals = [], [], []
    dims = None
    with open(path) as f:
        header = f.readline()
        if header.startswith("%%MatrixMarket") and "symmetric" in header:
            sym = True
        for line in f:
            if line.startswith("%") or not line.strip():
                continue
            parts = line.split()
            if dims is None:
                dims = (int(parts[0]), int(parts[1]))
                continue
            u, v = int(parts[0]) - 1, int(parts[1]) - 1
            src.append(u)
            dst.append(v)
            if len(parts) > 2:
                vals.append(float(parts[2]))
    nv = max(dims[0], dims[1])
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    if sym:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    g = from_edges(s, d, nv)
    return T.sort_and_clean(g)


def convert(
    in_path: str,
    out_dir: str,
    *,
    symmetrize: bool = False,
    clean: bool = False,
    orient: bool = False,
) -> CSRGraph:
    """The converter pipeline (src/converters/main.cc:5-34)."""
    if in_path.endswith(".mtx"):
        g = read_mtx(in_path, symmetrize=symmetrize)
    elif in_path.endswith(".gr"):
        g = read_gr(in_path)
        if symmetrize:
            g = T.symmetrize(g)
    else:
        g = load_graph(in_path)
        if symmetrize:
            g = T.symmetrize(g)
    if clean:
        g = T.sort_and_clean(g)
    if orient:
        g = T.orientation(g)
    save_graph(g, out_dir)
    return g
