"""The port's device graph against the JAX package's: the same ELL
buckets, CSR/COO arrays and transpose permutation, the same packed edge
values, and the mirrored numpy packing equal to the native packer."""

import numpy as np
import pytest
import torch

from graphaibench_tpu import native
from graphaibench_tpu.graph.csr import from_edges
from graphaibench_tpu.graph.generators import rmat, uniform_random
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu_torch.ops import device_graph as tdgm

torch.set_num_threads(2)

GRAPHS = {
    "rmat10": lambda: rmat(10, 8, seed=0),
    "uniform200": lambda: uniform_random(200, 600, seed=3),
    "isolated": lambda: from_edges([0, 1, 2, 5, 5, 5], [1, 0, 5, 2, 6, 7], 9),
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
