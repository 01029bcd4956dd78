"""The port's own host layer against the JAX package's: the CSR container,
generators, transforms, the native C++ kernels and their numpy routes,
the dataset readers and the CLI's dataset resolution. Every array must be
bit-equal (same dtype, same values): the port's device graph and weights
are built from them, and the tests of those compare like with like."""

import os

import numpy as np
import pytest

from graphaibench_tpu import native as jnative
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import io as jio
from graphaibench_tpu.graph import transforms as jT
from graphaibench_tpu_torch import cli as tcli
from graphaibench_tpu_torch import native as tnative
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import io as tio
from graphaibench_tpu_torch.graph import transforms as tT
from test_torch_sampler import jax_native  # noqa: F401  (a fixture)

GRAPHS = {
    "rmat10": ("rmat", (10, 8), {"seed": 0}),
    "rmat11": ("rmat", (11, 8), {"seed": 1}),
    "rmat12": ("rmat", (12, 4), {"seed": 2}),
    "rmat10_directed": ("rmat", (10, 8), {"seed": 3, "undirected": False}),
    "uniform200": ("uniform_random", (200, 600), {"seed": 3}),
    "uniform500": ("uniform_random", (500, 3000), {"seed": 5}),
}


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_graph(t, j):
    assert type(t) is tcsr.CSRGraph and type(j) is jcsr.CSRGraph
    assert (t.nv, t.ne) == (j.nv, j.ne)
    _same(t.row_ptr, j.row_ptr, "row_ptr")
    _same(t.col_idx, j.col_idx, "col_idx")


def _pair(name):
    fn, args, kw = GRAPHS[name]
    return getattr(tgen, fn)(*args, **kw), getattr(jgen, fn)(*args, **kw)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    return _pair(request.param)


def test_generators_bit_equal(pair):
    _same_graph(*pair)


def test_csr_accessors_match(pair):
    t, j = pair
    _same(t.degrees(), j.degrees(), "degrees")
    for a, b in zip(t.coo(), j.coo()):
        _same(a, b, "coo")
    _same(t.edge_sources(), j.edge_sources(), "edge_sources")
    assert t.max_degree() == j.max_degree()
    assert t.has_sorted_neighbors() and j.has_sorted_neighbors()
    _same(t.neighbors(3), j.neighbors(3), "neighbors")


@pytest.mark.parametrize("fn", ["add_selfloop", "symmetrize", "sort_and_clean"])
def test_graph_transforms_bit_equal(pair, fn):
    t, j = pair
    _same_graph(getattr(tT, fn)(t), getattr(jT, fn)(j))


def _masks(nv):
    rng = np.random.default_rng(11)
    return {"empty": np.zeros(nv, np.uint8), "full": np.ones(nv, np.uint8),
            "half": (rng.random(nv) < 0.5).astype(np.uint8),
            "sparse": (rng.random(nv) < 0.1).astype(np.uint8),
            "bool_prefix": np.arange(nv) < nv // 3}


@pytest.mark.parametrize("mask", ["empty", "full", "half", "sparse",
                                  "bool_prefix"])
def test_masked_and_induced_subgraph_bit_equal(pair, mask):
    """``masked_subgraph`` under the mask, and ``induced_subgraph`` on the
    mask's vertices (given unsorted and with repeats): graph and the
    local-to-global ids."""
    t, j = pair
    m = _masks(t.nv)[mask]
    _same_graph(tT.masked_subgraph(t, m), jT.masked_subgraph(j, m))
    vs = np.flatnonzero(m)[::-1]
    vs = np.concatenate([vs, vs[:3]])
    tsub, tl2g = tT.induced_subgraph(t, vs)
    jsub, jl2g = jT.induced_subgraph(j, vs)
    _same_graph(tsub, jsub)
    _same(tl2g, jl2g, "l2g")
    assert tsub.nv == int(np.asarray(m, bool).sum())


@pytest.mark.parametrize("fn", ["gcn_vertex_norms", "gcn_edge_norms",
                                "sage_edge_norms",
                                "transpose_edge_permutation"])
def test_edge_arrays_bit_equal(pair, fn):
    t, j = pair
    _same(getattr(tT, fn)(t), getattr(jT, fn)(j), fn)
    # and on the prepared (self-looped) graph the GCN path uses
    _same(getattr(tT, fn)(tT.add_selfloop(t)),
          getattr(jT, fn)(jT.add_selfloop(j)), f"{fn} with self-loops")


@pytest.mark.parametrize("ne,sort_neighbors", [
    (5000, True), (5000, False),
    (1 << 18, True), (1 << 18, False),   # at 2^18 edges the native build runs
])
def test_from_edges_bit_equal(ne, sort_neighbors):
    rng = np.random.default_rng(ne + sort_neighbors)
    nv = 3000
    src, dst = rng.integers(0, nv, ne), rng.integers(0, nv, ne)
    _same_graph(tcsr.from_edges(src, dst, nv, sort_neighbors=sort_neighbors),
                jcsr.from_edges(src, dst, nv, sort_neighbors=sort_neighbors))


def test_from_edges_keeps_edge_labels():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    lab = rng.integers(0, 9, 400).astype(np.int16)
    t = tcsr.from_edges(src, dst, 50, elabels=lab)
    j = jcsr.from_edges(src, dst, 50, elabels=lab)
    _same_graph(t, j)
    _same(t.elabels, j.elabels, "elabels")


def test_csr_rejects_bad_arrays():
    with pytest.raises(ValueError, match="bad CSR"):
        tcsr.CSRGraph(row_ptr=np.array([0, 2, 5]), col_idx=np.arange(4))
    with pytest.raises(ValueError, match="1-D"):
        tcsr.CSRGraph(row_ptr=np.zeros((2, 2)), col_idx=np.arange(4))


# ---- the native kernels and their numpy routes ---------------------------

def test_native_builds_into_the_checkout():
    assert tnative.available(), "g++ is on this host: the library must build"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tnative.BUILD_DIR == os.path.join(repo, "build", "native")
    assert any(f.endswith(".so") for f in os.listdir(tnative.BUILD_DIR))


@pytest.mark.parametrize("n,nkeys", [(0, 5), (1000, 7), (50000, 4096)])
def test_native_stable_key_sort_bit_equal(n, nkeys, jax_native):
    keys = np.random.default_rng(n).integers(0, nkeys, n).astype(np.int32)
    perm = tnative.stable_key_sort(keys, nkeys)
    _same(perm, jnative.stable_key_sort(keys, nkeys), "perm")
    _same(perm, np.argsort(keys, kind="stable").astype(np.int32), "argsort")


def test_native_stable_key_sort_rejects_out_of_range_keys():
    with pytest.raises(ValueError, match="outside"):
        tnative.stable_key_sort(np.array([0, 9], np.int32), 4)


@pytest.mark.parametrize("sort_neighbors", [True, False])
def test_native_build_csr_bit_equal(sort_neighbors, jax_native):
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 999, 20000), rng.integers(0, 999, 20000)
    t = tnative.build_csr(src, dst, 999, sort_neighbors=sort_neighbors)
    j = jnative.build_csr(src, dst, 999, sort_neighbors=sort_neighbors)
    for a, b in zip(t, j):
        _same(a, b, "build_csr")


@pytest.mark.parametrize("split,widths", [(64, [4, 8, 16, 32, 64]),
                                          (8, [4, 8]), (5, [4, 5])])
def test_native_ell_pack_bit_equal(pair, split, widths, jax_native):
    t, j = pair
    args = lambda g: (np.arange(g.nv, dtype=np.int32), g.row_ptr[:-1],  # noqa: E731
                      g.degrees().astype(np.int64), g.col_idx, None, g.ne,
                      widths, split)
    ours, ref = tnative.ell_pack(*args(t)), jnative.ell_pack(*args(j))
    assert [b[0] for b in ours] == [b[0] for b in ref]
    for o, r in zip(ours, ref):
        for a, b in zip(o[1:], r[1:]):
            _same(a, b, f"width {o[0]}")


def test_native_ell_pack_rejects_uncovered_widths():
    with pytest.raises(ValueError, match="widths"):
        tnative.ell_pack(np.arange(2, dtype=np.int32), [0, 1], [1, 1],
                         [0, 1], None, 2, [4, 8], 64)


def test_numpy_routes_equal_native(pair, monkeypatch):
    """Without a toolchain the wrappers return None and the callers take
    numpy: the same arrays either way."""
    t, _ = pair
    big = np.random.default_rng(1).integers(0, 2000, (2, 1 << 18))
    with_native = (tT.transpose_edge_permutation(t),
                   tcsr.from_edges(big[0], big[1], 2000))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)
    assert not tnative.available()
    assert tnative.ell_pack(None, None, None, None, None, 0, [4], 4) is None
    _same(tT.transpose_edge_permutation(t), with_native[0], "trans_perm")
    g = tcsr.from_edges(big[0], big[1], 2000)
    _same(g.row_ptr, with_native[1].row_ptr, "row_ptr")
    _same(g.col_idx, with_native[1].col_idx, "col_idx")


# ---- dataset readers -------------------------------------------------------

def _write_dataset(path, g, *, feats, vlabels, classes):
    half = g.nv // 2
    meta = jio.Meta(nv=g.nv, ne=g.ne, feat_len=0 if feats is None else feats.shape[1],
                    num_vertex_classes=classes, train=(0, half, half),
                    val=(half, g.nv - 10, g.nv - 10 - half),
                    test=(g.nv - 10, g.nv, 10))
    import dataclasses
    jio.save_graph(dataclasses.replace(g, vlabels=vlabels), str(path), meta=meta)
    if feats is not None:
        feats.tofile(os.path.join(path, "graph.feats.bin"))


def _same_dataset(t, j):
    _same_graph(t.graph, j.graph)
    for name in ("feats", "labels", "train_mask", "val_mask", "test_mask"):
        _same(getattr(t, name), getattr(j, name), name)
    for name in ("num_classes", "is_single_class", "train_range",
                 "val_range", "test_range", "feat_len"):
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("with_files,single,mmap", [
    (True, True, False), (True, False, False), (True, True, True),
    (False, True, False), (False, False, False),
])
def test_load_gnn_dataset_matches(tmp_path, with_files, single, mmap):
    """With feature and label files, and without (both packages then
    synthesize the same from the seed)."""
    rng = np.random.default_rng(4)
    g = jgen.rmat(8, 4, seed=4)
    _write_dataset(
        tmp_path, g, classes=5,
        feats=rng.standard_normal((g.nv, 12)).astype(np.float32)
        if with_files else None,
        vlabels=rng.integers(0, 5, g.nv).astype(np.uint8)
        if with_files else None)
    kw = dict(is_single_class=single, mmap=mmap, seed=3)
    t = tio.load_gnn_dataset(str(tmp_path), **kw)
    j = jio.load_gnn_dataset(str(tmp_path), **kw)
    assert type(t) is tio.GnnDataset
    _same_dataset(t, j)
    m = tio.read_meta(str(tmp_path))
    assert m == tio.Meta(**vars(jio.read_meta(str(tmp_path))))


def test_load_graph_rejects_a_meta_that_disagrees(tmp_path):
    g = jgen.rmat(6, 4, seed=0)
    jio.save_graph(g, str(tmp_path))
    with open(tmp_path / "graph.edge.bin", "ab") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="meta says"):
        tio.load_graph(str(tmp_path))


def _write_csgr_dataset(path, g, rng, classes=3, feat_len=6):
    """The legacy layout: <name>.csgr (Galois .gr, version 1, no edge
    data) and its sidecar files."""
    with open(path / "tiny.csgr", "wb") as f:
        np.array([1, 0, g.nv, g.ne], np.uint64).tofile(f)
        g.row_ptr[1:].astype(np.uint64).tofile(f)
        g.col_idx.astype(np.uint32).tofile(f)
    labels = rng.integers(0, classes, g.nv)
    with open(path / "tiny-labels.txt", "w") as f:
        f.write(f"{g.nv} {classes}\n")
        for lab in labels:
            f.write(" ".join("1" if c == lab else "0"
                             for c in range(classes)) + "\n")
    (path / "tiny-dims.txt").write_text(f"{g.nv} {feat_len}\n")
    rng.standard_normal((g.nv, feat_len)).astype(np.float32).tofile(
        path / "tiny-feats.bin")
    for kind, (b, e) in (("train", (0, 40)), ("val", (40, 52)),
                         ("test", (52, g.nv))):
        flags = rng.integers(0, 2, g.nv)
        (path / f"tiny-{kind}_mask.txt").write_text(
            f"{b} {e}\n" + "\n".join(map(str, flags)) + "\n")


@pytest.mark.parametrize("single", [True, False])
def test_load_gnn_dataset_csgr_matches(tmp_path, single):
    g = jgen.rmat(6, 4, seed=2)
    _write_csgr_dataset(tmp_path, g, np.random.default_rng(8))
    t = tio.load_gnn_dataset_csgr(str(tmp_path), is_single_class=single)
    j = jio.load_gnn_dataset_csgr(str(tmp_path), is_single_class=single)
    _same_dataset(t, j)
    _same_graph(t.graph, g)


def test_read_gr_rejects_an_unknown_version(tmp_path):
    np.array([7, 0, 0, 0], np.uint64).tofile(tmp_path / "bad.csgr")
    with pytest.raises(ValueError, match="version"):
        tio.read_gr(str(tmp_path / "bad.csgr"))


def test_resolve_dataset(tmp_path, monkeypatch):
    (tmp_path / "cora").mkdir()
    assert tcli.resolve_dataset(str(tmp_path / "cora")) == str(tmp_path / "cora")
    monkeypatch.setenv("DATASET_PATH", str(tmp_path))
    assert tcli.resolve_dataset("cora") == str(tmp_path / "cora")
    (tmp_path / "packed.meta.json").write_text("{}")
    assert tcli.resolve_dataset(str(tmp_path / "packed")) == str(tmp_path / "packed")
    with pytest.raises(SystemExit, match="not found"):
        tcli.resolve_dataset("no-such-dataset")
