"""The port's pull-mode analytics (``graphaibench_tpu_torch/analytics``:
the solvers of ``traversal``, ``pr`` and ``cc``, the serial ``verifiers``,
``run_benchmark`` and the CLI's ``analytics`` route) and the host copies
they need (``is_symmetric``, ``reverse``, ``grid2d``, ``save_graph``), held
against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages, on graphs
built by each package's own generators from the same parameters (and held
equal here). On the CPU the pull sweeps take ``neighbor_reduce``'s plain
version; the kernel is held against it by ``test_torch_neighbor_reduce.py``
and on the card by ``chip_smoke.py``. Tolerances: BFS depths and component
labels exact; SSSP distances equal to the JAX package's (both sweep in the
same order, and a sweep adds the same float32 terms and takes exact minima)
and within rtol 1e-5 of Dijkstra (``run_benchmark``'s check); PageRank
scores within atol 1e-6 of the JAX package's (float32 sums in another
order) with the same number of iterations, and within atol 1e-4 of the
serial verifier (``run_benchmark``'s check).
"""

import filecmp
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu import analytics as JA
from graphaibench_tpu.analytics import traversal as JTR
from graphaibench_tpu.analytics import verifiers as JV
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import io as jio
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu_torch.analytics import (
    bfs,
    bfs_frontier,
    bfs_host,
    connected_components,
    connected_components_afforest,
    pagerank,
    run_benchmark,
    sssp_bellman_ford,
    sssp_delta_stepping,
    verifiers as TV,
)
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import io as tio
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import device_graph as tdgm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PR_ATOL = 1e-6        # port against JAX
PR_VERIFY_ATOL = 1e-4  # run_benchmark's check
SSSP_RTOL = 1e-5       # run_benchmark's check


def _disconnected(gen, tr, csr):
    """Two rmat pieces side by side and isolated vertices after them."""
    a = gen.rmat(6, 4, seed=5)
    src, dst = a.coo()
    n = a.nv
    return tr.sort_and_clean(tr.symmetrize(csr.from_edges(
        np.r_[src, src + n], np.r_[dst, dst + n], 2 * n + 9)))


GRAPHS = {
    "rmat8": lambda gen, tr, csr: tr.sort_and_clean(tr.symmetrize(
        gen.rmat(8, 6, seed=11))),
    "rmat12": lambda gen, tr, csr: tr.sort_and_clean(tr.symmetrize(
        gen.rmat(12, 12, seed=3))),                 # split rows (degree > 64)
    "uniform": lambda gen, tr, csr: tr.sort_and_clean(
        gen.uniform_random(300, 1200, seed=9)),
    "grid24": lambda gen, tr, csr: gen.grid2d(24),
    "disconnected": _disconnected,
    "directed": lambda gen, tr, csr: gen.rmat(8, 6, seed=2, undirected=False),
    "edgeless": lambda gen, tr, csr: csr.from_edges([], [], 7),
}
SYMMETRIC = sorted(set(GRAPHS) - {"directed"})

_CACHE = {}


def _case(name):
    """(port graph, JAX graph, port device graph, JAX device graph), the
    device graphs built as ``run_benchmark`` builds them for SSSP: pull
    layouts (ELL buckets and the transpose) only on a symmetric graph."""
    if name not in _CACHE:
        t = GRAPHS[name](tgen, T, tcsr)
        j = GRAPHS[name](jgen, JT, jcsr)
        assert np.array_equal(t.row_ptr, j.row_ptr)
        assert np.array_equal(t.col_idx, j.col_idx)
        sym = T.is_symmetric(t)
        assert sym == (name != "directed")
        _CACHE[name] = (
            t, j,
            tdgm.to_device_graph(t, device="cpu", with_transpose=sym,
                                 with_ell=sym),
            jdgm.to_device_graph(j, with_transpose=sym, with_ell=sym))
    return _CACHE[name]


def _weights(g, kind: str, seed: int = 5) -> np.ndarray:
    """Float32 edge weights in CSR order: one draw per edge, or one per
    undirected edge (an edge and its reverse share the draw at the lower
    edge id)."""
    w = np.random.default_rng(seed).uniform(0.1, 2.0, g.ne).astype(np.float32)
    if kind == "symmetric":
        rev = T.transpose_edge_permutation(g)
        w = w[np.minimum(np.arange(g.ne), rev)]
    return w


# ---- the solvers -----------------------------------------------------------

@pytest.mark.parametrize("source", [0, 5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_matches_jax_and_verifier(name, source):
    g, jg, dg, jdg = _case(name)
    got = bfs(dg, source).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(JTR.bfs(jdg, source)))
    np.testing.assert_array_equal(got, TV.bfs_serial(g, source))


@pytest.mark.parametrize("budget", [1 << 6, 1 << 10, None])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_frontier_matches_jax_and_verifier(name, budget):
    """The JAX function cannot run on a graph without edges (its static
    gather of an empty edge list fails to trace): there the port is held
    to the verifier alone."""
    g, jg, dg, jdg = _case(name)
    got = bfs_frontier(dg, 0, edge_budget=budget).numpy()
    if g.ne:
        want = np.asarray(JTR.bfs_frontier(jdg, 0, edge_budget=budget))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TV.bfs_serial(g, 0))


@pytest.mark.parametrize("name", ["rmat12", "directed", "edgeless"])
def test_bfs_host_matches_jax(name):
    g, jg, _, _ = _case(name)
    got = bfs_host(g, 0, device="cpu")
    np.testing.assert_array_equal(got, JTR.bfs_host(jg, 0))
    np.testing.assert_array_equal(got, TV.bfs_serial(g, 0))


SSSP_SOLVERS = {
    "bellman_ford": (sssp_bellman_ford, JTR.sssp_bellman_ford, {}),
    "delta_default": (sssp_delta_stepping, JTR.sssp_delta_stepping, {}),
    "delta_0.3": (sssp_delta_stepping, JTR.sssp_delta_stepping,
                  {"delta": 0.3}),
}


@pytest.mark.parametrize("solver", sorted(SSSP_SOLVERS))
@pytest.mark.parametrize("weights", ["symmetric", "asymmetric"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sssp_matches_jax_and_dijkstra(name, weights, solver):
    g, jg, dg, jdg = _case(name)
    port_fn, jax_fn, kw = SSSP_SOLVERS[solver]
    w = _weights(g, weights) if g.ne else np.zeros(0, np.float32)
    got = port_fn(dg, torch.from_numpy(w), 0, **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jax_fn(jdg, jnp.asarray(w),
                                                         0, **kw)))
    assert np.allclose(got, TV.dijkstra_serial(g, w, 0), rtol=SSSP_RTOL,
                       equal_nan=True)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pagerank_matches_jax_and_verifier(name):
    """Symmetric graphs pull over their own buckets; the directed one
    pushes over the reverse graph (no buckets), as the solver's ``rg``."""
    g, jg, dg, jdg = _case(name)
    if name == "directed":
        rg, jrg = T.reverse(g), JT.reverse(jg)
        args = (tdgm.to_device_graph(rg, device="cpu", with_ell=False),)
        jargs = (jdgm.to_device_graph(jrg, with_ell=False),)
    else:
        rg, args, jargs = g, (), ()
    scores, iters = pagerank(dg, *args)
    jscores, jiters = JA.pagerank(jdg, *jargs)
    assert scores.dtype == torch.float32 and isinstance(iters, int)
    assert iters == int(jiters)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=0,
                               atol=PR_ATOL)
    np.testing.assert_allclose(scores.numpy(), TV.pagerank_serial(g, rg),
                               rtol=0, atol=PR_VERIFY_ATOL)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_connected_components_matches_jax(name):
    """Labels equal to the JAX package's; on symmetric graphs also to the
    verifier's (min vertex id of each component)."""
    g, jg, dg, jdg = _case(name)
    got = connected_components(dg).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got,
                                  np.asarray(JA.connected_components(jdg)))
    if name != "directed":
        np.testing.assert_array_equal(got, TV.cc_serial(g))


def _through_giant(csr, tr):
    """A band on ids 10..59 (the giant), chains 1-2-(10) and 3-4-(11)
    joined only through it, isolated 0 and 5..9."""
    cs, cd = [], []
    for u in range(10, 60):
        for v in range(u + 1, min(u + 5, 60)):
            cs.append(u), cd.append(v)
    return tr.sort_and_clean(tr.symmetrize(csr.from_edges(
        cs + [1, 2, 3, 4], cd + [2, 10, 4, 11], 60)))


AFFOREST = {
    "giant": lambda gen, tr, csr: tr.sort_and_clean(tr.symmetrize(
        gen.rmat(10, 6, seed=3))),
    "through_giant": lambda gen, tr, csr: _through_giant(csr, tr),
    "fallback_uniform": lambda gen, tr, csr: tr.sort_and_clean(
        tr.symmetrize(gen.uniform_random(150, 500, seed=9))),
    "fallback_pairs": lambda gen, tr, csr: tr.symmetrize(csr.from_edges(
        np.arange(0, 40, 2), np.arange(1, 40, 2), 41)),
    "edgeless": lambda gen, tr, csr: csr.from_edges([], [], 7),
}


@pytest.mark.parametrize("name", sorted(AFFOREST))
def test_afforest_matches_jax_and_verifier(name):
    g = AFFOREST[name](tgen, T, tcsr)
    jg = AFFOREST[name](jgen, JT, jcsr)
    got = connected_components_afforest(g, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, JA.connected_components_afforest(jg))
    np.testing.assert_array_equal(got, TV.cc_serial(g))
    if name == "through_giant":
        assert got[59] == 1        # the giant takes the fringe's label


# ---- the copies ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_is_symmetric_and_reverse_bit_equal(name):
    g, jg, _, _ = _case(name)
    assert T.is_symmetric(g) == JT.is_symmetric(jg)
    elab = np.random.default_rng(3).integers(0, 9, g.ne).astype(np.int16)
    for a, b in ((g, jg),
                 (tcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx,
                                elabels=elab),
                  jcsr.CSRGraph(row_ptr=jg.row_ptr, col_idx=jg.col_idx,
                                elabels=elab))):
        r, jr = T.reverse(a), JT.reverse(b)
        for f in ("row_ptr", "col_idx", "elabels"):
            x, y = getattr(r, f), getattr(jr, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert not T.is_symmetric(tgen.rmat(8, 6, seed=2, undirected=False))


@pytest.mark.parametrize("side", [1, 2, 7, 24, 65])
def test_grid2d_bit_equal(side):
    t, j = tgen.grid2d(side), jgen.grid2d(side)
    for f in ("row_ptr", "col_idx"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t.ne == 4 * side * (side - 1) and T.is_symmetric(t)


def _meta(mod, g):
    return mod.Meta(nv=g.nv, ne=g.ne, num_vertex_classes=4, feat_len=8,
                    train=(0, 100, 100), val=(100, 150, 50),
                    test=(150, 256, 106))


@pytest.mark.parametrize("what", ["plain", "meta", "labels", "bipartite"])
def test_save_graph_files_byte_equal(tmp_path, what):
    g = tgen.rmat(8, 6, seed=1)
    kw_t, kw_j = {}, {}
    if what == "meta":
        kw_t, kw_j = {"meta": _meta(tio, g)}, {"meta": _meta(jio, g)}
    rng = np.random.default_rng(2)
    vl = rng.integers(0, 5, g.nv).astype(np.uint8)
    el = rng.integers(0, 9, g.ne).astype(np.int16)
    extra = {}
    if what == "labels":
        extra = {"vlabels": vl, "elabels": el}
    elif what == "bipartite":
        extra = {"n_left": 100, "n_right": g.nv - 100}
    tg = tcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx, **extra)
    jg = jcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx, **extra)
    tio.save_graph(tg, str(tmp_path / "t"), **kw_t)
    jio.save_graph(jg, str(tmp_path / "j"), **kw_j)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert len(names) == (5 if what == "labels" else 3)
    for n in names:
        assert filecmp.cmp(tmp_path / "t" / n, tmp_path / "j" / n,
                           shallow=False), n
    back = tio.load_graph(str(tmp_path / "t"))
    assert np.array_equal(back.row_ptr, g.row_ptr)
    assert np.array_equal(back.col_idx, g.col_idx)


@pytest.mark.parametrize("name", ["rmat8", "uniform", "grid24", "disconnected",
                                  "directed", "edgeless"])
def test_verifiers_bit_equal(name):
    g, jg, _, _ = _case(name)
    w = _weights(g, "asymmetric", seed=8) if g.ne else np.zeros(0, np.float32)
    for src in (0, 3):
        for a, b in ((TV.bfs_serial(g, src), JV.bfs_serial(jg, src)),
                     (TV.dijkstra_serial(g, w, src),
                      JV.dijkstra_serial(jg, w, src)),
                     (TV.bc_serial(g, [src]), JV.bc_serial(jg, [src]))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in ((TV.pagerank_serial(g, g), JV.pagerank_serial(jg, jg)),
                 (TV.cc_serial(g), JV.cc_serial(jg))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dag = JT.orientation(jg)
    tdag = tcsr.CSRGraph(row_ptr=dag.row_ptr, col_idx=dag.col_idx)
    assert TV.triangle_count_serial(tdag) == JV.triangle_count_serial(dag)
    colors = np.arange(g.nv) % 3
    assert TV.coloring_valid(g, colors) == JV.coloring_valid(jg, colors)
    lat = np.random.default_rng(1).standard_normal((g.nv, 4)).astype(np.float32)
    ratings = np.ones(g.ne, np.float32)
    if g.ne:
        assert TV.cf_rmse(g, ratings, lat) == JV.cf_rmse(jg, ratings, lat)
    a, b = TV.kcore_serial(g), JV.kcore_serial(jg)
    assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- run_benchmark and the CLI ---------------------------------------------

@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """A symmetric and a directed dataset, written by the port's
    save_graph."""
    out = {}
    for name, g in (("sym", tgen.rmat(9, 8, seed=0)),
                    ("dir", tgen.rmat(8, 6, seed=2, undirected=False))):
        path = str(tmp_path_factory.mktemp(name))
        tio.save_graph(g, path)
        out[name] = path
    return out


def _cli(*args, **extra_env):
    env = dict(os.environ, OMP_NUM_THREADS="2", **extra_env)
    if "GAB_SHARDS" not in extra_env:
        env.pop("GAB_SHARDS", None)
    return subprocess.run(
        [sys.executable, "-m", "graphaibench_tpu_torch.cli", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def _lines(out: str) -> list[str]:
    """What a run prints, without its runtime and its device."""
    return [l for l in out.splitlines()
            if not l.startswith(("runtime = ", "device = "))]


@pytest.mark.parametrize("ds", ["sym", "dir"])
@pytest.mark.parametrize("kernel", ["bfs", "sssp", "pr", "cc", "tc", "bc",
                                    "kcore"])
def test_cli_analytics_prints_what_the_jax_route_prints(datasets, kernel, ds,
                                                       capsys):
    """``cli analytics <k> <dir> 0 --device=cpu``: exit 0 with ``Correct``
    on the symmetric dataset, and on both the JAX ``run_benchmark``'s
    lines and exit code, apart from the runtime and the device."""
    r = _cli("analytics", kernel, datasets[ds], "0", "--device=cpu")
    lines = r.stdout.splitlines()
    assert "device = cpu" in lines
    assert sum(l.startswith("runtime = ") for l in lines) == 1
    if ds == "sym":
        assert r.returncode == 0 and "Correct" in lines, r.stdout + r.stderr
    capsys.readouterr()
    rc = JA.run_benchmark(kernel, datasets[ds], ["0"])
    assert r.returncode == rc, r.stderr
    assert _lines(r.stdout) == _lines(capsys.readouterr().out)


def test_run_benchmark_in_process(datasets, capsys):
    for kernel in ("bfs", "pr"):
        assert run_benchmark(kernel, datasets["sym"], [], device="cpu") == 0
        out = capsys.readouterr().out.splitlines()
        assert "Correct" in out and "device = cpu" in out


@pytest.mark.parametrize("case,item", [
    ("cf", "P15"), ("motif", "P15"), ("sample", "P15"), ("color", "P15"),
    ("shards", "P14c")])
def test_unported_routes_exit_2_and_name_their_item(datasets, case, item):
    """The unported solvers exit 2 naming their item. ``GAB_SHARDS`` (P14c)
    is ported since: it runs the distributed solver, with no refusal."""
    env, kernel = {}, case
    if case == "shards":
        env, kernel = {"GAB_SHARDS": "2"}, "bfs"
    r = _cli("analytics", kernel, datasets["sym"], "--device=cpu", **env)
    if case == "shards":
        assert r.returncode == 0, r.stderr
        lines = r.stdout.splitlines()
        assert "distributed over 2 rank(s) on cpu (gloo)" in lines
        assert "Correct" in lines and item not in r.stderr
        return
    assert r.returncode == 2
    assert item in r.stderr and "ROADMAP" in r.stderr
    assert "Correct" not in r.stdout


def test_cli_analytics_decodes_a_streamvbyte_prefix(datasets, tmp_path):
    """A StreamVByte prefix decodes through the device route (K11; its plain
    versions with ``--device=cpu``) and the solve is Correct."""
    from graphaibench_tpu_torch.compress import cli as tccli
    from graphaibench_tpu_torch.compress import vbyte as tvbyte

    g = tio.load_graph(datasets["sym"])
    path = str(tmp_path / "packed")
    tccli.save_compressed(tvbyte.encode_graph(g, "streamvbyte"), path)
    r = _cli("analytics", "bfs", path, "--device=cpu")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert "decoded streamvbyte on device cpu" in lines
    assert f"|V| {g.nv} |E| {g.ne}" in lines and "Correct" in lines


@pytest.mark.parametrize("ds", ["sym", "dir", "labelled"])
def test_cli_info_prints_what_the_jax_cli_prints(datasets, ds, tmp_path,
                                                 capsys):
    """``cli info <dir>``: the JAX CLI's lines, exit 0; on a dataset with
    vertex labels, features and mask ranges too."""
    from graphaibench_tpu import cli as jcli

    path = datasets.get(ds)
    if ds == "labelled":
        g = tgen.rmat(8, 6, seed=4)
        g = tcsr.CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx,
                          vlabels=(np.arange(g.nv) % 5).astype(np.uint8))
        path = str(tmp_path / "labelled")
        tio.save_graph(g, path, meta=tio.Meta(
            nv=g.nv, ne=g.ne, feat_len=12, num_vertex_classes=5,
            train=(0, 100, 100), val=(100, 150, 50), test=(150, 256, 106)))
    r = _cli("info", path)
    assert r.returncode == 0, r.stderr
    capsys.readouterr()
    assert jcli.cmd_info([path]) == 0
    assert r.stdout.splitlines() == capsys.readouterr().out.splitlines()
    assert r.stdout.startswith("|V| ")


def test_cli_info_refuses_a_compressed_prefix(tmp_path):
    """A prefix whose files are not a compressed graph is refused; a CGR
    prefix prints the JAX CLI's two lines (tests/test_torch_compress.py
    holds them equal)."""
    (tmp_path / "packed.meta.json").write_text("{}")
    r = _cli("info", str(tmp_path / "packed"))
    assert r.returncode == 2
    assert "not a compressed-graph prefix" in r.stderr
    from graphaibench_tpu_torch.compress import cgr as tcgr
    from graphaibench_tpu_torch.compress import cli as tccli

    g = T.sort_and_clean(tgen.rmat(8, 6, seed=4))
    tccli.save_compressed(tcgr.encode_graph(g), str(tmp_path / "cgr"))
    r = _cli("info", str(tmp_path / "cgr"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0] == (f"(compressed prefix, decoded) |V| "
                                        f"{g.nv} |E| {g.ne}")
    r = _cli("info")
    assert r.returncode == 2 and "usage: info" in r.stdout


def test_cli_analytics_refusals(datasets):
    r = _cli("analytics", "bfs", datasets["sym"], "--device=tpu")
    assert r.returncode == 2 and "--device" in r.stderr
    r = _cli("analytics", "nope", datasets["sym"], "--device=cpu")
    assert r.returncode == 2 and "unknown kernel" in r.stdout
    r = _cli("analytics", "bfs")
    assert r.returncode == 2 and "usage: analytics" in r.stdout
    r = _cli("serve")
    assert r.returncode == 2 and "train|analytics" in r.stdout


def test_default_device_does_not_fall_back_to_the_cpu(datasets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _cli("analytics", "bfs", datasets["sym"], "0")
    assert r.returncode != 0 and "Correct" not in r.stdout
