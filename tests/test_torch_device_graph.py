"""The port's device graph against the JAX package's: the same ELL
buckets, CSR/COO arrays and transpose permutation, the same packed edge
values, the numpy packing equal to the native packer, and the arrays
derived for the kernel's store-or-add rule equal to their definition."""

import numpy as np
import pytest
import torch

from graphaibench_tpu import native
from graphaibench_tpu.graph.csr import from_edges
from graphaibench_tpu.graph.generators import rmat, uniform_random
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu_torch.ops import device_graph as tdgm

torch.set_num_threads(2)

def hubs_graph():
    """Symmetric stars: vertex 0 has degree exactly 64 (one virtual row,
    the widest unsplit), vertex 100 degree 65 (split: 64 + 1), vertex 200
    degree 199 (split: 64 + 64 + 64 + 7); their leaves have degree 1 and
    vertices 65..99 and 166..199 are isolated."""
    src = np.concatenate([np.zeros(64), np.full(65, 100), np.full(199, 200)])
    dst = np.concatenate([np.arange(1, 65), np.arange(101, 166),
                          np.arange(201, 400)])
    return from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      400)


GRAPHS = {
    "rmat10": lambda: rmat(10, 8, seed=0),
    "uniform200": lambda: uniform_random(200, 600, seed=3),
    "isolated": lambda: from_edges([0, 1, 2, 5, 5, 5], [1, 0, 5, 2, 6, 7], 9),
    "hubs": hubs_graph,
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("split", [None, 8])
def test_device_graph_matches_jax(graph, split):
    """The whole device graph at the default split; the buckets alone at
    split 8, where small graphs split many rows."""
    jdg = jdgm.to_device_graph(graph, seg_ell=False)
    tdg = tdgm.to_device_graph(graph, device="cpu")
    assert (tdg.nv, tdg.ne) == (jdg.nv, jdg.ne)
    for name in ("row_ptr", "col_idx", "edge_src", "deg", "trans_perm"):
        t, j = getattr(tdg, name), getattr(jdg, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), _np(j), err_msg=name)
    tell, jell = tdg.ell, jdg.ell
    if split is not None:
        tell = tdgm.build_ell_buckets(graph, device="cpu", split=split)
        jell = jdgm.build_ell_buckets(graph, split=split)
    assert [b.width for b in tell] == [b.width for b in jell]
    assert len(tell) > 0
    for tb, jb in zip(tell, jell):
        for name in ("row_ids", "nbr", "edge_id"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          _np(getattr(jb, name)),
                                          err_msg=f"w{tb.width} {name}")
        assert tb.rows == jb.rows


def test_pack_edge_values_match_jax(graph):
    w = np.random.default_rng(1).standard_normal(graph.ne).astype(np.float32)
    jp = jdgm.pack_edge_values(jdgm.to_device_graph(graph, seg_ell=False), w)
    tp = tdgm.pack_edge_values(tdgm.to_device_graph(graph, device="cpu"),
                               torch.from_numpy(w))
    np.testing.assert_array_equal(tp.raw.numpy(), w)
    assert len(tp.fwd) == len(jp.fwd) and len(tp.t) == len(jp.t)
    for t, j in zip(tp.fwd + tp.t, jp.fwd + jp.t):
        np.testing.assert_array_equal(t.numpy(), _np(j))


@pytest.mark.parametrize("split", [64, 8])
def test_numpy_packing_equals_native(graph, split):
    if not native.available():
        pytest.skip("no g++: the native packer is not built on this host")
    widths = tdgm._widths_for_split(split)
    args = (np.arange(graph.nv, dtype=np.int32), graph.row_ptr[:-1],
            graph.degrees().astype(np.int64), graph.col_idx, None, graph.ne,
            widths, split)
    ours = tdgm._pack_rows_numpy(*args)
    ref = native.ell_pack(*args)
    assert [b[0] for b in ours] == [b[0] for b in ref]
    for o, r in zip(ours, ref):
        for a, b in zip(o[1:], r[1:]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_rmat10_splits_heavy_rows():
    """The rmat10 case reaches the width-64 bucket with split rows, so the
    tests above exercise the scatter-add layout."""
    g = GRAPHS["rmat10"]()
    tdg = tdgm.to_device_graph(g, device="cpu")
    assert g.degrees().max() > tdgm.ELL_SPLIT
    wide = tdg.ell[-1]
    assert wide.width == tdgm.ELL_SPLIT
    assert len(torch.unique(wide.row_ids)) < wide.rows or any(
        len(set(b.row_ids.tolist()) & set(wide.row_ids.tolist()))
        for b in tdg.ell[:-1])


def test_split_flags_and_zero_rows_follow_the_degrees(graph):
    """``is_split`` and ``zero_rows`` by their definition, and by what the
    kernel needs of them: every row is written by exactly one store, or
    is zeroed first and then only added to (or never touched)."""
    tdg = tdgm.to_device_graph(graph, device="cpu")
    deg = graph.degrees()
    assert tdg.is_split.dtype == torch.uint8
    assert tdg.zero_rows.dtype == torch.int64
    np.testing.assert_array_equal(tdg.is_split.numpy(),
                                  (deg > tdgm.ELL_SPLIT).astype(np.uint8))
    np.testing.assert_array_equal(
        tdg.zero_rows.numpy(),
        np.flatnonzero((deg == 0) | (deg > tdgm.ELL_SPLIT)))
    pieces = np.bincount(
        np.concatenate([b.row_ids.numpy() for b in tdg.ell]),
        minlength=graph.nv)
    np.testing.assert_array_equal(pieces > 1, deg > tdgm.ELL_SPLIT)
    np.testing.assert_array_equal(pieces == 0, deg == 0)
    stored = pieces == 1
    zeroed = np.zeros(graph.nv, bool)
    zeroed[tdg.zero_rows.numpy()] = True
    np.testing.assert_array_equal(stored, ~zeroed)


def test_hubs_graph_has_the_boundary_degrees():
    g = hubs_graph()
    deg = g.degrees()
    assert (deg[0], deg[100], deg[200]) == (64, 65, 199)
    assert (deg[65:100] == 0).all() and (deg[166:200] == 0).all()
    tdg = tdgm.to_device_graph(g, device="cpu")
    assert tdg.is_split[[0, 100, 200]].tolist() == [0, 1, 1]
    assert set(tdg.zero_rows.tolist()) == {100, 200, *range(65, 100),
                                           *range(166, 200)}
    wide = tdg.ell[-1]
    assert wide.width == 64
    assert sorted(wide.row_ids.tolist()) == [0, 100, 200, 200, 200]


def test_packed_views_are_slot_weights(graph):
    tdg = tdgm.to_device_graph(graph, device="cpu")
    wp = tdgm.pack_edge_values(tdg, torch.ones(graph.ne))
    for view in (wp.fwd, wp.t):
        assert isinstance(view, tdgm.SlotWeights) and isinstance(view, tuple)
        assert len(view) == len(tdg.ell)
        assert view.launch_table is None
