"""The port's distributed analytics against the JAX package's, on the CPU.

1. K8 on a rank's rectangular forward table (``local_table``: nv_pad rows
   over the own and halo rows): int32 min, int32 sum, float32 sum and the
   float32 min-plus with packed slot weights against a numpy loop over
   the shard's edges, through ``ell_gather_reduce`` and
   ``ell_gather_reduce_plus``; a rank without edges gives the identity;
   the wrapper refuses ``vals`` of the wrong length.
2. The solvers of ``parallel/dist_analytics.py`` over 2 and over 4 gloo
   ranks (4: the 2 x 2 grid of the 2-D count, and blocks of unequal edge
   counts), each launch running every case at once, against JAX's
   ``graphaibench_tpu/parallel/dist_analytics.py`` on a mesh of the first
   P of the 8 virtual CPU devices (tests/conftest.py), run as
   tests/test_parallel.py runs it, on its graphs: depths, labels,
   coreness and triangle counts equal; SSSP within rtol 1e-5, atol 1e-5;
   PageRank within rtol 1e-4, atol 1e-7; BC within rtol 1e-5, atol 1e-5;
   sweep, iteration and level counts equal. Against the port's serial
   verifiers with the same tolerances, PageRank within JAX's own 2e-3.
   A symmetric graph whose nv (293) is no multiple of 8 P, with isolated
   vertices, runs the vertex solvers too.
3. ``run_benchmark`` under ``GAB_SHARDS=2`` with ``device="cpu"``: Correct
   and exit 0 for tc, bfs and kcore on a generated dataset, printing JAX's
   lines; ``cc`` on a directed graph runs single-device.

The ranks are spawned processes that import this module, so jax is
imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from graphaibench_tpu_torch.analytics import run_benchmark
from graphaibench_tpu_torch.analytics import verifiers as V
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.graph.csr import from_edges
from graphaibench_tpu_torch.graph.generators import rmat
from graphaibench_tpu_torch.graph.io import save_graph
from graphaibench_tpu_torch.ops import ell_pull as K8
from graphaibench_tpu_torch.parallel import dist_analytics as DA
from graphaibench_tpu_torch.parallel import multihost
from graphaibench_tpu_torch.parallel import partition as tpart
from graphaibench_tpu_torch.parallel import shard_ell as tse

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 240
INF = 2**30
BC_SOURCES = [0, 7, 19]
SSSP = dict(rtol=1e-5, atol=1e-5)
BC = dict(rtol=1e-5, atol=1e-5)
PR_JAX = dict(rtol=1e-4, atol=1e-7)
PR_SERIAL = dict(rtol=2e-3, atol=1e-7)     # tests/test_parallel.py's


def _ragged():
    """Symmetric, nv = 293 (no multiple of 8 P), the ids from 256 on
    isolated."""
    src, dst = rmat(8, 4, seed=29).coo()
    return T.sort_and_clean(T.symmetrize(from_edges(src, dst, 293)))


def _graphs() -> dict:
    """tests/test_parallel.py's graphs (PageRank and SSSP on directed
    ones), a symmetric rmat(10, 8) for the counts and the ragged graph."""
    return {
        "pr": rmat(9, 8, seed=11, undirected=False),
        "sym": T.sort_and_clean(T.symmetrize(rmat(9, 6, seed=13))),
        "small": T.sort_and_clean(T.symmetrize(rmat(8, 6, seed=23))),
        "sssp": T.sort_and_clean(rmat(9, 6, seed=17, undirected=False)),
        "tc": T.sort_and_clean(rmat(10, 8, seed=3)),
        "ragged": _ragged(),
    }


def _sssp_weights(g) -> np.ndarray:
    return np.random.default_rng(5).uniform(0.1, 4.0, g.ne).astype(
        np.float32)


# the vertex solvers: case -> (graph, solver)
VERTEX_CASES = {
    "bfs": ("sym", "bfs"), "cc": ("sym", "cc"), "kcore": ("small", "kcore"),
    "bc": ("small", "bc"), "sssp": ("sssp", "sssp"), "pr": ("pr", "pr"),
    "ragged_bfs": ("ragged", "bfs"), "ragged_cc": ("ragged", "cc"),
    "ragged_kcore": ("ragged", "kcore"), "ragged_bc": ("ragged", "bc"),
    "ragged_pr": ("ragged", "pr"), "ragged_sssp": ("ragged", "sssp"),
}


def _port_solve(solver: str, g):
    """(the rank's own rows, count or None) of one port solver."""
    kw = dict(device="cpu")
    if solver == "bfs":
        return DA.distributed_bfs(g, 0, **kw)
    if solver == "cc":
        return DA.distributed_cc(g, **kw)
    if solver == "kcore":
        return DA.distributed_kcore(g, **kw)
    if solver == "bc":
        return DA.distributed_bc(g, BC_SOURCES, **kw), None
    if solver == "sssp":
        return DA.distributed_sssp(g, _sssp_weights(g), 0, **kw)
    return DA.distributed_pagerank(g, **kw)


def _rank_cases(rank: int, n: int) -> dict:
    """Every case on this rank: {case: (the gathered (nv,) result, count)}
    and the two triangle counts."""
    torch.set_num_threads(1)
    graphs = _graphs()
    out = {}
    for case, (gname, solver) in VERTEX_CASES.items():
        g = graphs[gname]
        x, count = _port_solve(solver, g)
        per = -(-g.nv // n)
        assert x.shape == (-(-per // 8) * 8,)      # nv_pad rows
        out[case] = (DA.gather_own(x, g.nv).numpy(), count)
    out["tc"] = DA.distributed_triangle_count(graphs["tc"], device="cpu")
    out["tc_2d"] = DA.distributed_triangle_count_2d(graphs["tc"],
                                                    device="cpu")
    return out


def _jax_cases(p: int) -> dict:
    """JAX's solvers on a mesh of the first ``p`` devices, on the same
    graphs (the JAX package's CSRGraph of the same arrays)."""
    import jax
    from jax.sharding import Mesh

    from graphaibench_tpu.graph.csr import CSRGraph as JCSR
    from graphaibench_tpu.parallel import dist_analytics as JDA

    mesh = Mesh(np.asarray(jax.devices()[:p]), ("graph",))
    graphs = {k: JCSR(row_ptr=g.row_ptr, col_idx=g.col_idx)
              for k, g in _graphs().items()}
    out = {}
    for case, (gname, solver) in VERTEX_CASES.items():
        g = graphs[gname]
        if solver == "bfs":
            out[case] = JDA.distributed_bfs(mesh, g, 0)
        elif solver == "cc":
            out[case] = JDA.distributed_cc(mesh, g)
        elif solver == "kcore":
            out[case] = JDA.distributed_kcore(mesh, g)
        elif solver == "bc":
            out[case] = (JDA.distributed_bc(mesh, g, BC_SOURCES), None)
        elif solver == "sssp":
            out[case] = JDA.distributed_sssp(mesh, g, _sssp_weights(g), 0)
        else:
            out[case] = JDA.distributed_pagerank(mesh, g)
    out["tc"] = JDA.distributed_triangle_count(mesh, graphs["tc"])
    out["tc_2d"] = JDA.distributed_triangle_count_2d(mesh, graphs["tc"])
    return out


@pytest.fixture(scope="module")
def results():
    """{P: (every rank's cases, JAX's cases)} for P = 2 and 4: the two
    launches run in threads while this process runs JAX's solvers."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        spawned = {p: pool.submit(multihost.launch, _rank_cases, p,
                                  timeout_s=SPAWN_TIMEOUT_S) for p in (2, 4)}
        jax_res = {p: _jax_cases(p) for p in (2, 4)}
        return {p: (spawned[p].result(), jax_res[p]) for p in (2, 4)}


def _hold(solver: str, got, want, tol_pr=PR_JAX) -> None:
    if solver in ("bfs", "cc", "kcore"):
        np.testing.assert_array_equal(got, want)
    elif solver == "sssp":
        np.testing.assert_allclose(got, want, **SSSP)
    elif solver == "bc":
        np.testing.assert_allclose(got, want, **BC)
    else:
        np.testing.assert_allclose(got, want, **tol_pr)


# ---- 1. K8 on a rank's rectangular table -----------------------------------

def _rect_shard(rank: int, shards: int = 2):
    """A rank's shard of rmat(9, 6) joined to a hub in the last block (so
    each rank has split rows), with random weights."""
    src, dst = T.symmetrize(rmat(9, 6, seed=13)).coo()
    hub, leaves = 511, np.arange(0, 400, 3)
    g = T.sort_and_clean(T.symmetrize(from_edges(
        np.r_[src, np.full(len(leaves), hub)], np.r_[dst, leaves], 512)))
    rg = T.reverse(g)
    w = np.random.default_rng(1).uniform(0.1, 4.0, rg.ne).astype(np.float32)
    return tpart.build_sharded_graph(rg, w, shards).shard(rank)


def _numpy_reduce(shard, x_ext, kind, w=None):
    """The reduction over the shard's real edges, one edge at a time."""
    n_e = int(shard.edge_valid.sum())
    ident = K8.identity(kind, torch.from_numpy(x_ext).dtype)
    out = np.full(shard.nv_pad, ident, dtype=x_ext.dtype)
    for k in range(n_e):
        r, c = shard.edge_src[k], shard.col_idx[k]
        v = x_ext[c] if w is None else x_ext[c] + w[k]
        out[r] = (min(out[r], v) if kind == "min" else max(out[r], v)
                  if kind == "max" else out[r] + v)
    return out


@pytest.mark.parametrize("case", ["int32 min", "int32 sum", "float32 sum",
                                  "float32 min-plus"])
@pytest.mark.parametrize("rank", [0, 1])
def test_k8_on_a_rank_table_matches_numpy(rank, case):
    shard = _rect_shard(rank)
    se = tse.build_shard_ell(shard, with_trans=False)
    fwd = se.fwd
    assert fwd.n_cols == shard.nv_pad + shard.h_max != fwd.nv
    assert shard.halo_count > 0 and bool(fwd.is_split.any())
    rng = np.random.default_rng(rank)
    dtype, kind = case.split()
    if dtype == "int32":
        x = rng.integers(-1000, 1000, fwd.n_cols).astype(np.int32)
    else:
        x = rng.standard_normal(fwd.n_cols).astype(np.float32)
    xt = torch.from_numpy(x)
    if kind == "min-plus":
        packed = tse.pack_shard_values(
            se, torch.from_numpy(shard.edge_w)).fwd
        got = tse.ell_gather_reduce_plus(fwd, packed, xt, shard.nv_pad,
                                         "min", se.sentinel)
        want = _numpy_reduce(shard, x, "min", shard.edge_w)
    else:
        got = tse.ell_gather_reduce(fwd, xt, shard.nv_pad, kind, se.sentinel)
        want = _numpy_reduce(shard, x, kind)
    assert got.dtype == xt.dtype and got.shape == (shard.nv_pad,)
    if case == "float32 sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_k8_on_a_rank_table_refuses_vals_of_the_wrong_length():
    shard = _rect_shard(0)
    se = tse.build_shard_ell(shard, with_trans=False)
    for n in (se.fwd.nv, se.fwd.n_cols + 1):
        with pytest.raises(ValueError, match="shape"):
            K8.neighbor_reduce(se.fwd, torch.zeros(n, dtype=torch.int32),
                               "min")
    with pytest.raises(ValueError, match="rows"):
        tse.ell_gather_reduce(se.fwd, torch.zeros(se.fwd.n_cols), 8, "sum",
                              se.sentinel)
    with pytest.raises(ValueError, match="min or max"):
        tse.ell_gather_reduce_plus(se.fwd, None, torch.zeros(se.fwd.n_cols),
                                   shard.nv_pad, "sum", se.sentinel)


def test_k8_on_a_rank_without_edges_gives_the_identity():
    """Rank 1 of 2 over a graph whose edges all lie in rank 0's block."""
    g = from_edges(np.array([0, 1]), np.array([1, 0]), 20)
    shard = tpart.build_sharded_graph(g, np.ones(2, np.float32), 2).shard(1)
    se = tse.build_shard_ell(shard, with_trans=False)
    assert not se.fwd.has_ell_layout
    x = torch.arange(se.fwd.n_cols, dtype=torch.int32)
    out = tse.ell_gather_reduce(se.fwd, x, shard.nv_pad, "min", se.sentinel)
    assert torch.equal(out, torch.full((shard.nv_pad,),
                                       torch.iinfo(torch.int32).max,
                                       dtype=torch.int32))


# ---- 2. the solvers against JAX and the serial verifiers --------------------

@pytest.mark.parametrize("case", list(VERTEX_CASES))
@pytest.mark.parametrize("p", [2, 4])
def test_solver_matches_jax(p, case, results):
    ranks, jax_res = results[p]
    solver = VERTEX_CASES[case][1]
    got, count = ranks[0][case]
    want, want_count = jax_res[case]
    _hold(solver, got, np.asarray(want))
    assert count == want_count
    for r in ranks[1:]:     # every rank gathers the same result
        np.testing.assert_array_equal(r[case][0], got)
        assert r[case][1] == count


@pytest.mark.parametrize("case", list(VERTEX_CASES))
@pytest.mark.parametrize("p", [2, 4])
def test_solver_matches_the_serial_verifier(p, case, results):
    ranks = results[p][0]
    gname, solver = VERTEX_CASES[case]
    g = _graphs()[gname]
    got, count = ranks[0][case]
    if solver == "bfs":
        ref = V.bfs_serial(g, 0)
        unreach = ref < 0
        np.testing.assert_array_equal(got[~unreach], ref[~unreach])
        assert np.all(got[unreach] == INF)
        assert 1 < count <= g.nv
    elif solver == "cc":
        np.testing.assert_array_equal(got, V.cc_serial(g))
    elif solver == "kcore":
        np.testing.assert_array_equal(got, V.kcore_serial(g))
        assert count == got.max() + 1 >= 1
    elif solver == "bc":
        np.testing.assert_allclose(got, V.bc_serial(g, BC_SOURCES), **BC)
    elif solver == "sssp":
        ref = V.dijkstra_serial(g, _sssp_weights(g), 0)
        fin = np.isfinite(ref)
        assert np.all(np.isinf(got[~fin]))
        np.testing.assert_allclose(got[fin], ref[fin], **SSSP)
        assert 1 < count <= g.nv
    else:
        np.testing.assert_allclose(got, V.pagerank_serial(g, T.reverse(g)),
                                   **PR_SERIAL)
        assert 1 < count <= 100


@pytest.mark.parametrize("route", ["tc", "tc_2d"])
@pytest.mark.parametrize("p", [2, 4])
def test_triangle_count_matches_jax_and_serial(p, route, results):
    ranks, jax_res = results[p]
    g = _graphs()["tc"]
    assert T.is_symmetric(g)
    want = V.triangle_count_serial(T.orientation(g))
    assert want > 0
    assert [r[route] for r in ranks] == [want] * p
    assert jax_res[route] == want


@pytest.mark.parametrize("s", [2, 3])
def test_2d_blocks_sum_to_the_count(s):
    """Each block of an s x s grid laid out as its rank lays it out (local
    rows, global neighbour ids), counted in this process: the blocks'
    counts sum to the serial count, and none of them holds all of it."""
    from graphaibench_tpu_torch.analytics.tc import sorted_dag
    from graphaibench_tpu_torch.ops import tc_count as K9

    g = _graphs()["tc"]
    dag = sorted_dag(g)
    counts = [int(K9.tc_count_plain(DA.block_edges_2d(dag, s, i, j,
                                                      device="cpu")))
              for i in range(s) for j in range(s)]
    want = V.triangle_count_serial(T.orientation(g))
    assert sum(counts) == want
    assert max(counts) < want


def test_the_cases_cover_what_they_claim():
    graphs = _graphs()
    assert not T.is_symmetric(graphs["pr"])
    assert not T.is_symmetric(graphs["sssp"])
    ragged = graphs["ragged"]
    assert ragged.nv % 32 and ragged.nv % 16
    assert (ragged.degrees() == 0).sum() >= ragged.nv - 256
    # the partitions at 4 ranks have blocks of unequal edge counts
    sg = tpart.build_sharded_graph(T.reverse(graphs["sym"]),
                                   np.ones(graphs["sym"].ne, np.float32), 4)
    counts = sg.edge_valid.sum(1)
    assert counts.max() > 2 * counts.min()


# ---- 3. the CLI route --------------------------------------------------------

@pytest.fixture(scope="module")
def cli_datasets(tmp_path_factory):
    out = {}
    for name, g in (("sym", rmat(9, 8, seed=0)),
                    ("dir", rmat(8, 6, seed=2, undirected=False))):
        path = str(tmp_path_factory.mktemp(f"dist_{name}"))
        save_graph(g, path)
        out[name] = path
    return out


def _lines(out: str) -> list[str]:
    """What a distributed run prints, without its runtime and its
    ``distributed over`` line (JAX names devices, the port ranks)."""
    return [l for l in out.splitlines()
            if not l.startswith(("runtime = ", "distributed over "))]


@pytest.mark.parametrize("kernel", ["tc", "bfs", "kcore"])
def test_run_benchmark_gab_shards(kernel, cli_datasets, monkeypatch, capsys):
    from graphaibench_tpu import analytics as JA

    monkeypatch.setenv("GAB_SHARDS", "2")
    assert run_benchmark(kernel, cli_datasets["sym"], ["0"],
                         device="cpu") == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert "distributed over 2 rank(s) on cpu (gloo)" in lines
    assert "Correct" in lines and "device = cpu" not in lines
    assert JA.run_benchmark(kernel, cli_datasets["sym"], ["0"]) == 0
    assert _lines(out) == _lines(capsys.readouterr().out)


def test_run_benchmark_gab_shards_directed_cc_runs_single_device(
        cli_datasets, monkeypatch, capsys):
    monkeypatch.setenv("GAB_SHARDS", "2")
    assert run_benchmark("cc", cli_datasets["dir"], [], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert ("directed input: distributed cc needs a symmetric graph; "
            "running single-device") in lines
    assert "device = cpu" in lines
    assert not any(l.startswith("distributed over") for l in lines)


@pytest.mark.parametrize("spec,n", [("auto", 1), ("3", 3)])
def test_count_ranks(spec, n):
    assert multihost.count_ranks(spec, "cpu") == n
    for bad in ("0", "-1", "x", ""):
        with pytest.raises(ValueError, match="positive count or auto"):
            multihost.count_ranks(bad, "cpu")
