"""The port's pattern solvers and the rest of P15b, held against the JAX
package on the CPU: ``graph/labels.py`` (the NLF on K1's plain version and
on the host route), ``analytics/motif.py`` and ``fsm.py``,
``analytics/{community,linkpred,hac,assignment}.py``,
``graph/converters.py`` and ``transforms.{dense_adjacency,relabel,
locality_order}``, and the ``motif`` and ``fsm`` routes of
``run_benchmark``.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: none. Counts and supports are integers and must be equal; the
numpy copies must give equal arrays (floats bit for bit). One stated
difference: the port sums its motif counts in float64 where JAX sums in
float32, so on a dense graph whose sums pass 2^24 the port gives the exact
counts (an exact numpy oracle here) and JAX's square and 4-clique are off
(``test_motif_counts_are_exact_above_float32``).
"""

import numpy as np
import pytest
import torch

from graphaibench_tpu import analytics as JA
from graphaibench_tpu.analytics import assignment as JASG
from graphaibench_tpu.analytics import community as JCOM
from graphaibench_tpu.analytics import fsm as JFSM
from graphaibench_tpu.analytics.hac import cut_clusters as jcut_clusters
from graphaibench_tpu.analytics.hac import hac as jhac
from graphaibench_tpu.analytics.hac import hac_from_embeddings as jhac_emb
from graphaibench_tpu.analytics import linkpred as JLP
from graphaibench_tpu.analytics import motif as JMOT
from graphaibench_tpu.graph import converters as JCONV
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import labels as JLAB
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch.analytics import assignment as ASG
from graphaibench_tpu_torch.analytics import community as COM
from graphaibench_tpu_torch.analytics import fsm as FSM
from graphaibench_tpu_torch.analytics.hac import (
    cut_clusters,
    hac,
    hac_from_embeddings,
)
from graphaibench_tpu_torch.analytics import linkpred as LP
from graphaibench_tpu_torch.analytics import motif as MOT
from graphaibench_tpu_torch.analytics import run_benchmark
from graphaibench_tpu_torch.graph import converters as CONV
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import io as tio
from graphaibench_tpu_torch.graph import labels as LAB
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import device_graph as DG

torch.set_num_threads(2)


def _random_graph(csr, n, p, seed):
    """``tests/test_motif.py::_random_graph`` in package ``csr``."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1)
    src, dst = np.nonzero(a | a.T)
    return csr.from_edges(src, dst, n)


def _labeled(n, p, L, seed):
    """A random graph in each package and its seeded labels, as
    ``tests/test_fsm.py::_random_labeled`` draws them."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1)
    src, dst = np.nonzero(a | a.T)
    lab = rng.integers(0, L, n).astype(np.int32)
    return jcsr.from_edges(src, dst, n), tcsr.from_edges(src, dst, n), lab


def _pair(build):
    """The graph ``build(gen, transforms, csr)`` in each package, equal."""
    jg, tg = build(jgen, JT, jcsr), build(tgen, T, tcsr)
    assert np.array_equal(jg.row_ptr, tg.row_ptr)
    assert np.array_equal(jg.col_idx, tg.col_idx)
    return jg, tg


def _messy(gen, tr, csr):
    """Directed, with self-loops and a duplicate edge: what the dense
    adjacency symmetrizes and cleans."""
    g = gen.rmat(6, 4, seed=3, undirected=False)
    src, dst = g.coo()
    return csr.from_edges(np.r_[src, [5, 5, 7]], np.r_[dst, [5, 9, 9]], g.nv)


def _equal_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---- graph/transforms.py ----------------------------------------------------

@pytest.mark.parametrize("build", [
    _messy, lambda gen, tr, csr: gen.rmat(7, 6, seed=1)])
def test_dense_adjacency_host_and_device_equal_jax(build):
    jg, tg = _pair(build)
    want = JT.dense_adjacency(jg)
    _equal_arrays(T.dense_adjacency(tg), want)
    _equal_arrays(T.dense_adjacency(tg, np.int64),
                  JT.dense_adjacency(jg, np.int64))
    _equal_arrays(DG.dense_adjacency(tg, device="cpu").numpy(), want)
    src, dst = DG.undirected_pairs(tg)
    ws, wd = np.nonzero(np.triu(want))
    assert np.array_equal(src, ws) and np.array_equal(dst, wd)


@pytest.mark.parametrize("method", ["louvain", "bfs"])
def test_locality_order_and_relabel_equal_jax(method):
    def build(gen, tr, csr):
        g = gen.rmat(8, 6, seed=2)
        return csr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx,
                            vlabels=(np.arange(g.nv) % 7).astype(np.uint8))

    jg, tg = _pair(build)
    perm = T.locality_order(tg, method)
    _equal_arrays(perm, JT.locality_order(jg, method))
    assert np.array_equal(np.sort(perm), np.arange(tg.nv))
    jr, tr = JT.relabel(jg, perm), T.relabel(tg, perm)
    for name in ("row_ptr", "col_idx", "vlabels"):
        _equal_arrays(getattr(tr, name), getattr(jr, name))
    assert tr.elabels is None and tr.ne == tg.ne


# ---- graph/labels.py --------------------------------------------------------

@pytest.mark.parametrize("n,p,L,seed", [(40, 0.2, 5, 0), (30, 0.3, 4, 1),
                                        (25, 0.25, 1, 2)])
def test_nlf_both_routes_and_label_structures_equal_jax(n, p, L, seed):
    """The NLF on K1's plain version (unit weights, the one-hot) and on the
    host route equals JAX's device and host NLF; the reverse index, the
    frequencies and the NLF filter are numpy copies."""
    jg, tg, lab = _labeled(n, p, L, seed)
    want = JLAB.neighborhood_label_frequency(jg, lab)
    _equal_arrays(JLAB.neighborhood_label_frequency(jg, lab, device=False),
                  want)
    _equal_arrays(LAB.neighborhood_label_frequency(tg, lab, device="cpu"),
                  want)
    _equal_arrays(LAB.neighborhood_label_frequency(tg, lab, device=False),
                  want)
    assert LAB.num_labels(tg, lab) == JLAB.num_labels(jg, lab)
    _equal_arrays(LAB.label_frequency(tg, lab), JLAB.label_frequency(jg, lab))
    ti, ji = LAB.label_index(tg, lab), JLAB.label_index(jg, lab)
    assert ti.keys() == ji.keys()
    for k in ji:
        _equal_arrays(ti[k], ji[k])
    pat = np.random.default_rng(seed).integers(0, 3, (4, L + 1)).astype(
        np.int32)
    _equal_arrays(LAB.nlf_match(want, pat), JLAB.nlf_match(want, pat))


def test_nlf_counts_self_loops_duplicates_and_empty_rows():
    """Self-loops and duplicate edges count as JAX's scatter counts them;
    rows of degree 0 (which K1's table skips) read 0; a graph without
    edges takes the host route."""
    jg, tg = _pair(_messy)
    lab = (np.arange(tg.nv) * 7 % 3).astype(np.int32)
    assert (tg.degrees() == 0).any()
    _equal_arrays(LAB.neighborhood_label_frequency(tg, lab, device="cpu"),
                  JLAB.neighborhood_label_frequency(jg, lab))
    empty = tcsr.CSRGraph(row_ptr=np.zeros(4, np.int64),
                          col_idx=np.zeros(0, np.int32), vlabels=lab[:3])
    assert LAB.neighborhood_label_frequency(empty, device="cpu").sum() == 0


@pytest.mark.parametrize("n,p,L,seed", [(30, 0.35, 3, 2), (24, 0.5, 2, 3)])
def test_labeled_triangle_counts_equal_jax(n, p, L, seed):
    jg, tg, lab = _labeled(n, p, L, seed)
    got = LAB.labeled_triangle_counts(tg, lab, device="cpu")
    assert got == JLAB.labeled_triangle_counts(jg, lab)
    assert sum(got.values()) == MOT.motif_counts(tg, 3, device="cpu")[
        "triangle"]


# ---- analytics/motif.py -----------------------------------------------------

@pytest.mark.parametrize("p,seed", [(0.2, 0), (0.35, 1), (0.5, 2), (0.7, 3)])
def test_motif_counts_equal_jax_and_brute_force(p, seed):
    jg = _random_graph(jcsr, 22, p, seed)
    tg = _random_graph(tcsr, 22, p, seed)
    brute = MOT.brute_force_motif_counts(tg, 4)
    assert brute == JMOT.brute_force_motif_counts(jg, 4)
    for k in (3, 4):
        got = MOT.motif_counts(tg, k, device="cpu")
        assert got == JMOT.motif_counts(jg, k)
        assert got == {name: brute[name] for name in got}
    induced = MOT.induced_motif_counts(tg, device="cpu")
    assert induced == JMOT.induced_motif_counts(jg)
    assert {k: induced[k] for k in brute["_induced"]} == brute["_induced"]
    for name in MOT._PATTERN_EDGES:
        for ind in (False, True):
            assert (MOT.count_pattern(tg, name, induced=ind, device="cpu")
                    == JMOT.count_pattern(jg, name, induced=ind))


def test_motif_counts_on_messy_and_empty_graphs():
    """A directed graph with self-loops and duplicates is counted on its
    symmetrized simple graph, as JAX's dense adjacency makes it; a small
    ``edge_chunk`` leaves the counts; a graph without edges counts 0."""
    jg, tg = _pair(_messy)
    want = JMOT.motif_counts(jg, 4)
    assert MOT.motif_counts(tg, 4, device="cpu") == want
    assert MOT.motif_counts(tg, 4, edge_chunk=7, device="cpu") == want
    empty = tcsr.CSRGraph(row_ptr=np.zeros(6, np.int64),
                          col_idx=np.zeros(0, np.int32))
    assert set(MOT.motif_counts(empty, 4, device="cpu").values()) == {0}
    with pytest.raises(ValueError, match="3- and 4-vertex"):
        MOT.motif_counts(tg, 5, device="cpu")


def test_patterns_equal_jax():
    for name, edges in MOT._PATTERN_EDGES.items():
        tp, jp = MOT.Pattern.from_name(name), JMOT.Pattern.from_name(name)
        assert (tp.name, tp.n, tp.m, tp.max_degree, tp.is_clique()) == (
            jp.name, jp.n, jp.m, jp.max_degree, jp.is_clique())
        assert MOT.Pattern.from_edges(edges[::-1]).edges == (
            JMOT.Pattern.from_edges(edges[::-1]).edges)
        _equal_arrays(tp.to_graph().col_idx, jp.to_graph().col_idx)
    assert MOT.Pattern(edges=((0, 1), (1, 2)), num_vertex_classes=3).name == (
        "3labeled-wedge")
    assert np.array_equal(MOT._SUPER, JMOT._SUPER)


def _exact_square_and_k4(n, p, seed) -> tuple[int, int]:
    """The exact square and 4-clique counts of ``_random_graph(n, p,
    seed)`` in numpy integers: tr(A⁴) = Σ A2∘A2 and 24·K4 = Σ A∘(CᵀC)."""
    a = np.triu(np.random.default_rng(seed).random((n, n)) < p, 1)
    A = (a | a.T).astype(np.int64)
    deg = A.sum(1)
    m = int(deg.sum()) // 2
    A2 = A @ A
    closed4 = int((A2 * A2).sum())
    square = (closed4 - 2 * m - 2 * int((deg * (deg - 1)).sum())) // 8
    src, dst = np.nonzero(A)
    C = (A[src] * A[dst]).astype(np.float64)
    # float64 BLAS: every entry and partial sum is an integer below 2^53
    gram = (C.T @ C).astype(np.int64)
    k4 = int((A * gram).sum()) // 24
    return square, k4


def test_motif_counts_are_exact_above_float32():
    """The stated difference. On ``_random_graph(160, 0.8, 0)`` tr(A⁴) and
    24·K4 pass 2^24: the port's float64 sums give the exact square
    32,735,389 and 4-clique 7,035,144 (an exact numpy oracle), where JAX's
    float32 sums give 32,735,384 and 7,035,143; every other count of the
    two packages is equal."""
    exact = _exact_square_and_k4(160, 0.8, 0)
    assert exact == (32_735_389, 7_035_144)
    got = MOT.motif_counts(_random_graph(tcsr, 160, 0.8, 0), 4, device="cpu")
    assert (got["square"], got["4-clique"]) == exact
    jax_counts = JMOT.motif_counts(_random_graph(jcsr, 160, 0.8, 0), 4)
    assert (jax_counts["square"], jax_counts["4-clique"]) != exact
    for name in set(got) - {"square", "4-clique"}:
        assert got[name] == jax_counts[name], name


# ---- analytics/fsm.py -------------------------------------------------------

def _patterns(pats):
    return [(f.kind, f.labels, f.support) for f in pats]


@pytest.mark.parametrize("n,p,L,seed,min_support", [
    (20, 0.3, 3, 5, 1), (22, 0.25, 4, 6, 1), (18, 0.4, 2, 7, 3)])
def test_fsm_equals_jax(n, p, L, seed, min_support):
    """Each miner's patterns and supports equal JAX's; ``fsm`` is the
    miners' patterns in order, the edges alone at ``max_size`` 2."""
    jg, tg, lab = _labeled(n, p, L, seed)
    mined = []
    for name in ("mine_edges", "mine_wedges", "mine_triangles"):
        got = getattr(FSM, name)(tg, lab, min_support=min_support,
                                 device="cpu")
        want = getattr(JFSM, name)(jg, lab, min_support=min_support)
        assert _patterns(got) == _patterns(want), name
        mined += got
    assert FSM.fsm(tg, lab, min_support=min_support, device="cpu") == mined
    assert FSM.fsm(tg, lab, min_support=min_support, max_size=2,
                   device="cpu") == mined[:len(FSM.mine_edges(
                       tg, lab, min_support=min_support, device="cpu"))]


def test_fsm_reads_the_graphs_labels():
    jg, tg, lab = _labeled(20, 0.3, 3, 9)
    tg = tcsr.CSRGraph(row_ptr=tg.row_ptr, col_idx=tg.col_idx,
                       vlabels=lab.astype(np.uint8))
    assert _patterns(FSM.fsm(tg, device="cpu")) == _patterns(
        JFSM.fsm(jg, lab))
    with pytest.raises(ValueError, match="no vertex labels"):
        FSM.fsm(_random_graph(tcsr, 10, 0.3, 0), device="cpu")


# ---- analytics/{community,linkpred,hac,assignment}.py -----------------------

@pytest.mark.parametrize("build", [
    lambda gen, tr, csr: gen.rmat(8, 6, seed=0),
    lambda gen, tr, csr: gen.rmat(7, 4, seed=5)])
def test_louvain_and_modularity_equal_jax(build):
    jg, tg = _pair(build)
    labels, q = COM.louvain(tg)
    jlabels, jq = JCOM.louvain(jg)
    _equal_arrays(labels, jlabels)
    assert q == jq
    w = np.random.default_rng(1).random(tg.ne)
    assert COM.modularity(tg, labels, w) == JCOM.modularity(jg, labels, w)
    _equal_arrays(COM.louvain(tg, w)[0], JCOM.louvain(jg, w)[0])


@pytest.mark.parametrize("metric", ["jaccard", "cn", "aa"])
def test_link_scores_and_predictions_equal_jax(metric):
    jg, tg = _pair(lambda gen, tr, csr: gen.rmat(6, 4, seed=1))
    pairs = np.random.default_rng(2).integers(0, tg.nv, (40, 2))
    for name in ("jaccard", "common_neighbors", "adamic_adar"):
        _equal_arrays(getattr(LP, name)(tg, pairs),
                      getattr(JLP, name)(jg, pairs))
    _equal_arrays(LP.predict_links(tg, 12, metric),
                  JLP.predict_links(jg, 12, metric))


@pytest.mark.parametrize("linkage", ["single", "complete", "average"])
def test_hac_and_cut_clusters_equal_jax(linkage):
    x = np.random.default_rng(3).standard_normal((30, 5))
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    link = hac(d, linkage)
    _equal_arrays(link, jhac(d, linkage))
    x32 = x.astype(np.float32)
    _equal_arrays(hac_from_embeddings(x32, linkage), jhac_emb(x32, linkage))
    for k in (1, 4, 30):
        _equal_arrays(cut_clusters(link, 30, k), jcut_clusters(link, 30, k))


@pytest.mark.parametrize("n,seed", [(5, 0), (6, 1), (7, 2)])
def test_hungarian_equals_jax_and_the_oracle(n, seed):
    cost = np.random.default_rng(seed).random((n, n)) * 10
    col, total = ASG.hungarian(cost)
    jcol, jtotal = JASG.hungarian(cost)
    _equal_arrays(col, jcol)
    assert total == jtotal
    assert ASG.assignment_oracle(cost) == JASG.assignment_oracle(cost)
    assert abs(total - ASG.assignment_oracle(cost)) < 1e-9


# ---- graph/converters.py ----------------------------------------------------

def _write_mtx(path, symmetric: bool, values: bool):
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(1, 41, 120), rng.integers(1, 41, 120)
    head = ("%%MatrixMarket matrix coordinate "
            f"{'real' if values else 'pattern'} "
            f"{'symmetric' if symmetric else 'general'}\n")
    body = "".join(f"{r} {c}" + (f" {v:.3f}" if values else "") + "\n"
                   for r, c, v in zip(rows, cols, rng.random(120)))
    path.write_text(head + "% a comment\n\n40 40 120\n" + body)


def _write_gr(path, g):
    """A Galois .gr file (version 1, 4-byte edge data) of ``g``."""
    with open(path, "wb") as f:
        np.array([1, 4, g.nv, g.ne], np.uint64).tofile(f)
        g.row_ptr[1:].astype(np.uint64).tofile(f)
        g.col_idx.astype(np.uint32).tofile(f)
        if g.ne % 2:
            f.write(b"\0" * 4)
        np.arange(g.ne, dtype=np.uint32).tofile(f)


@pytest.mark.parametrize("symmetric,values", [(False, False), (True, True)])
def test_read_mtx_equals_jax(tmp_path, symmetric, values):
    path = tmp_path / "m.mtx"
    _write_mtx(path, symmetric, values)
    for flag in (False, True):
        got = CONV.read_mtx(str(path), symmetrize=flag)
        want = JCONV.read_mtx(str(path), symmetrize=flag)
        _equal_arrays(got.row_ptr, want.row_ptr)
        _equal_arrays(got.col_idx, want.col_idx)


@pytest.mark.parametrize("source", ["mtx", "gr", "dir"])
def test_convert_writes_the_files_jax_writes(tmp_path, source):
    g = tgen.rmat(6, 4, seed=7, undirected=False)
    if source == "mtx":
        src = tmp_path / "in.mtx"
        _write_mtx(src, False, False)
    elif source == "gr":
        src = tmp_path / "in.gr"
        _write_gr(src, g)
        got = CONV.read_gr(str(src))
        _equal_arrays(got.elabels, JCONV.read_gr(str(src)).elabels)
        _equal_arrays(got.col_idx, g.col_idx)
    else:
        src = tmp_path / "in"
        tio.save_graph(g, str(src))
    for flags in ({}, {"symmetrize": True, "clean": True},
                  {"clean": True, "orient": True}):
        tag = "_".join(flags) or "plain"
        CONV.convert(str(src), str(tmp_path / f"t_{tag}"), **flags)
        JCONV.convert(str(src), str(tmp_path / f"j_{tag}"), **flags)
        names = sorted(p.name for p in (tmp_path / f"j_{tag}").iterdir())
        assert sorted(p.name for p in (tmp_path / f"t_{tag}").iterdir()) == (
            names)
        for name in names:
            assert ((tmp_path / f"t_{tag}" / name).read_bytes()
                    == (tmp_path / f"j_{tag}" / name).read_bytes()), name
    assert CONV.read_gr is tio.read_gr


# ---- the motif and fsm routes of run_benchmark ------------------------------

@pytest.fixture(scope="module")
def labeled_dataset(tmp_path_factory):
    """rmat(8, 6) with 4 seeded vertex labels, written by the port's
    save_graph."""
    g = tgen.rmat(8, 6, seed=3)
    lab = np.random.default_rng(5).integers(0, 4, g.nv).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("labeled"))
    tio.save_graph(tcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx,
                                 vlabels=lab), path)
    return path


def _lines(out: str) -> list[str]:
    return [l for l in out.splitlines()
            if not l.startswith(("runtime = ", "device = "))]


@pytest.mark.parametrize("kernel,args", [
    ("motif", []), ("motif", ["3"]), ("motif", ["4", "induced"]),
    ("motif", ["3", "induced"]), ("fsm", []), ("fsm", ["3", "2"])])
def test_routes_print_what_the_jax_route_prints(labeled_dataset, kernel, args,
                                               capsys):
    """Exit 0 and ``Correct``, and the JAX route's lines apart from the
    runtime and the device."""
    assert run_benchmark(kernel, labeled_dataset, args, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Correct" in out.splitlines() and "device = cpu" in out
    assert JA.run_benchmark(kernel, labeled_dataset, args) == 0
    assert _lines(out) == _lines(capsys.readouterr().out)


def test_fsm_route_refuses_a_dataset_without_labels(tmp_path, capsys):
    path = str(tmp_path / "plain")
    tio.save_graph(tgen.rmat(6, 4, seed=0), path)
    assert run_benchmark("fsm", path, [], device="cpu") == 2
    assert "dataset has no vertex labels" in capsys.readouterr().out
    assert JA.run_benchmark("fsm", path, []) == 2

