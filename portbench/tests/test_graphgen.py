"""The benchmark's graph: R-MAT draws cut to a published vertex and edge
count keep the first distinct pairs drawn, and a graph is made once."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import graphgen

SPEC = {"generator": "rmat", "scale": 10, "edge_factor": 8, "seed": 3,
        "a": 0.57, "b": 0.19, "c": 0.19, "num_nodes": 600,
        "num_edges_undirected": 2000}


def _edges(row_ptr, col_idx) -> set:
    return {(r, int(c)) for r in range(len(row_ptr) - 1)
            for c in col_idx[row_ptr[r]:row_ptr[r + 1]]}


def test_cut_graph_is_the_first_pairs_drawn(tmp_path, monkeypatch):
    monkeypatch.setattr(graphgen, "CACHE_DIR", tmp_path)
    rp, ci = graphgen.make_graph(SPEC, "cpu")
    src, dst = graphgen.rmat_draws(10, 8, 3, 0.57, 0.19, 0.19)
    nv, want, pairs = SPEC["num_nodes"], set(), []
    for s, d in zip(src.tolist(), dst.tolist()):
        pair = (min(s, d), max(s, d))
        if s == d or max(s, d) >= nv or pair in want:
            continue
        want.add(pair)
        pairs.append(pair)
        if len(pairs) == SPEC["num_edges_undirected"]:
            break
    assert len(rp) - 1 == nv and len(ci) == 2 * len(pairs)
    assert _edges(rp, ci) == want | {(d, s) for s, d in want}
    assert all(np.all(np.diff(ci[rp[r]:rp[r + 1]]) > 0) for r in range(nv))
    again = graphgen.make_graph(SPEC, "cpu")     # from the cache
    assert np.array_equal(again[0], rp) and np.array_equal(again[1], ci)
    assert [p.name for p in tmp_path.iterdir()] == [
        graphgen.cache_path(SPEC).name]


def test_too_few_draws_for_the_pairs_asked_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(graphgen, "CACHE_DIR", tmp_path)
    with pytest.raises(ValueError, match="distinct pairs"):
        graphgen.make_graph({**SPEC, "num_edges_undirected": 10**6}, "cpu")
