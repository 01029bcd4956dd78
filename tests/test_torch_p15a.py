"""The port's device analytics solvers of P15a (``analytics/``: ``mst``,
``cf``, ``ann``, ``khop``, ``embedding``) and their CLI routes (``color``,
``cf``, ``embed``, ``sample``), held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages, on graphs
built by each package's generators and held equal. Tolerances: Borůvka's
edge ids and total exact (integer ranks decide every pick); kNN indices exact
on scores without ties; CF's latents and RMSE history within rtol 1e-5
(float32 sums in another order: the SpMM over ELL slots against JAX's
segment sum). JAX draws from ``jax.random`` and the port from a
``torch.Generator``, so the samplers' and walkers' steps are fed JAX's draws,
rebuilt here from ``PRNGKey(seed)`` with the splits of ``khop.py:41-47``,
``:67-77`` and ``embedding.py:51-86``, ``:154-160``, and must give JAX's
edges and walks exactly; skip-gram fed JAX's negatives gives JAX's
embeddings within rtol 1e-4, atol 1e-6 (duplicate rows' updates added in
another order over 3 epochs). The port's own runs are held to properties:
every sampled or walked edge is an edge, walks stall at degree 0, the
embeddings are finite.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu import analytics as JA
from graphaibench_tpu.analytics import ann as JANN
from graphaibench_tpu.analytics import cf as JCF
from graphaibench_tpu.analytics import embedding as JEMB
from graphaibench_tpu.analytics import khop as JKHOP
from graphaibench_tpu.analytics import mst as JMST
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch.analytics import ann as ANN
from graphaibench_tpu_torch.analytics import cf as CF
from graphaibench_tpu_torch.analytics import embedding as EMB
from graphaibench_tpu_torch.analytics import khop as KHOP
from graphaibench_tpu_torch.analytics import mst as MST
from graphaibench_tpu_torch.analytics import run_benchmark
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import io as tio
from graphaibench_tpu_torch.graph import transforms as T

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CF_RTOL = 1e-5
SKIPGRAM = dict(rtol=1e-4, atol=1e-6)


def _pair(build):
    """The graph ``build(gen, transforms, csr)`` in each package, equal."""
    jg, tg = build(jgen, JT, jcsr), build(tgen, T, tcsr)
    assert np.array_equal(jg.row_ptr, tg.row_ptr)
    assert np.array_equal(jg.col_idx, tg.col_idx)
    return jg, tg


def _with_selfloops(gen, tr, csr):
    g = gen.rmat(9, 6, seed=4)
    src, dst = g.coo()
    loops = np.arange(0, g.nv, 3)
    return tr.sort_and_clean(csr.from_edges(np.r_[src, loops],
                                            np.r_[dst, loops], g.nv))


def _disconnected(gen, tr, csr):
    """Two rmat pieces side by side and isolated vertices after them."""
    a = gen.rmat(6, 4, seed=5)
    src, dst = a.coo()
    n = a.nv
    return tr.sort_and_clean(tr.symmetrize(csr.from_edges(
        np.r_[src, src + n], np.r_[dst, dst + n], 2 * n + 9)))


GRAPHS = {
    "rmat10": lambda gen, tr, csr: gen.rmat(10, 8, seed=0),
    "directed": lambda gen, tr, csr: gen.rmat(8, 6, seed=2, undirected=False),
    "selfloops": _with_selfloops,
    "disconnected": _disconnected,
    "edgeless": lambda gen, tr, csr: csr.from_edges(
        np.zeros(0, np.int64), np.zeros(0, np.int64), 17),
}


def _symmetric_weights(g, seed: int, ties: bool) -> np.ndarray:
    """One weight an undirected edge, the same in both directions; with
    ``ties`` from 4 values, so that the pair ranks break the ties."""
    src, dst = g.coo()
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    rng = np.random.default_rng(seed)
    key = lo.astype(np.int64) * g.nv + hi
    uniq, inv = np.unique(key, return_inverse=True)
    w = (rng.integers(1, 5, len(uniq)) if ties
         else rng.random(len(uniq)) + 0.5)
    return w[inv].astype(np.float64)


# ---- Borůvka ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("ties", [False, True])
def test_boruvka_equals_jax(name, ties):
    jg, tg = _pair(GRAPHS[name])
    w = _symmetric_weights(tg, 3, ties)
    jids, jtotal = JMST.boruvka_mst(jg, w)
    ids, total = MST.boruvka_mst(tg, w, device="cpu")
    assert np.array_equal(ids, jids)
    assert total == jtotal
    if name != "directed":
        assert total == pytest.approx(MST.kruskal_oracle(tg, w), rel=1e-12)


@pytest.mark.parametrize("name", ["rmat10", "disconnected", "selfloops"])
def test_kruskal_oracle_equals_jax(name):
    jg, tg = _pair(GRAPHS[name])
    w = _symmetric_weights(tg, 4, False)
    assert MST.kruskal_oracle(tg, w) == JMST.kruskal_oracle(jg, w)


# ---- collaborative filtering ----------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("step", [CF.STEP, 1e-3])
def test_cf_train_equals_jax(name, step):
    """Seeded ratings in [1, 5]; the reference's step and one large enough
    to move the latents (10 iterations)."""
    jg, tg = _pair(GRAPHS[name])
    r = np.random.default_rng(1).integers(1, 6, tg.ne).astype(np.float32)
    lat0 = np.random.default_rng(2).random((tg.nv, 8)).astype(np.float32)
    kw = dict(k=8, step=step, max_iters=10, latents=lat0)
    jl, jh = JCF.cf_train(jg, r, **kw)
    tl, th = CF.cf_train(tg, r, device="cpu", **kw)
    np.testing.assert_allclose(th, jh, rtol=CF_RTOL, equal_nan=True)
    np.testing.assert_allclose(tl, jl, rtol=CF_RTOL, atol=1e-7)
    assert len(th) == len(jh)


def test_cf_defaults_and_init_equal_jax():
    jg, tg = _pair(GRAPHS["rmat10"])
    assert np.array_equal(CF.init_latents(5), JCF.init_latents(5))
    assert (CF.K, CF.LAMBDA, CF.STEP, CF.MAX_ITERS, CF.CF_EPSILON) == (
        JCF.K, JCF.LAMBDA, JCF.STEP, JCF.MAX_ITERS, JCF.CF_EPSILON)
    r = np.random.default_rng(3).integers(1, 6, tg.ne).astype(np.float32)
    jl, jh = JCF.cf_train(jg, r)
    tl, th = CF.cf_train(tg, r, device="cpu")
    np.testing.assert_allclose(th, jh, rtol=CF_RTOL)
    np.testing.assert_allclose(tl, jl, rtol=CF_RTOL)
    assert th[-1] <= th[0]


# ---- kNN -------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("k", [1, 7])
def test_knn_equals_jax(metric, k):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((33, 24)).astype(np.float32)
    ji, js = JANN.knn_search(x, q, k, metric=metric)
    ti, ts = ANN.knn_search(x, q, k, metric=metric, device="cpu")
    srt = np.sort(js, axis=1)
    assert (np.diff(srt, axis=1) != 0).all()      # no ties among the top k
    assert np.array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


# ---- k-hop samples and walks on JAX's draws --------------------------------

def _wg(tg):
    return KHOP.walk_graph(tg, "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _jax_fails_on_edgeless(name, fn) -> bool:
    """On the edgeless graph JAX's padded neighbour table indexes an empty
    col_idx and raises (``khop.py::_padded_nbrs``); the port's steps give
    every vertex its self-edge (a stated difference, ROADMAP queue 3)."""
    if name != "edgeless":
        return False
    with pytest.raises(IndexError):
        fn()
    return True


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_khop_step_on_jax_draws_equals_jax(name):
    jg, tg = _pair(GRAPHS[name])
    seeds = np.arange(min(40, tg.nv))
    fanouts = (5, 3, 2)
    if _jax_fails_on_edgeless(
            name, lambda: JKHOP.khop_sample(jg, seeds, fanouts, seed=7)):
        hops = KHOP.khop_sample(tg, seeds, fanouts, seed=7, device="cpu")
        assert all(np.array_equal(s, d) for s, d in hops)
        return
    want = JKHOP.khop_sample(jg, seeds, fanouts, seed=7)
    deg = jnp.asarray(tg.degrees().astype(np.int32))
    key = jax.random.PRNGKey(7)
    frontier = jnp.asarray(seeds.astype(np.int32))
    wg = _wg(tg)
    for (jsrc, jdst), fanout in zip(want, fanouts):
        key, sub = jax.random.split(key)
        r = jax.random.randint(sub, (frontier.shape[0], fanout), 0,
                               jnp.maximum(deg[frontier], 1)[:, None])
        srcs, dsts = KHOP._khop_step(wg, _t(frontier), _t(r))
        assert np.array_equal(srcs.reshape(-1).numpy(), jsrc)
        assert np.array_equal(dsts.reshape(-1).numpy(), jdst)
        frontier = jnp.asarray(jdst)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_walk_step_on_jax_draws_equals_jax(name):
    jg, tg = _pair(GRAPHS[name])
    starts = np.arange(tg.nv)
    if _jax_fails_on_edgeless(
            name, lambda: JKHOP.random_walk(jg, starts, 6, seed=3)):
        walks = KHOP.random_walk(tg, starts, 6, seed=3, device="cpu")
        assert (walks == starts[:, None]).all()
        return
    want = JKHOP.random_walk(jg, starts, 6, seed=3)
    deg = jnp.asarray(tg.degrees().astype(np.int32))
    key = jax.random.PRNGKey(3)
    cur = jnp.asarray(starts.astype(np.int32))
    wg = _wg(tg)
    got = [_t(cur)]
    for _ in range(6):
        key, sub = jax.random.split(key)
        r = jax.random.randint(sub, cur.shape, 0, jnp.maximum(deg[cur], 1))
        got.append(KHOP._walk_step(wg, got[-1], _t(r)))
        cur = jnp.asarray(got[-1].numpy().astype(np.int32))
    assert np.array_equal(torch.stack(got, 1).numpy(), want)


def _node2vec_on_jax_draws(jg, tg, starts, length, p, q, seed):
    """JAX's node2vec walks and the port's step fed the same draws."""
    want = JEMB.node2vec_walks(jg, starts, length, p=p, q=q, seed=seed)
    deg = jnp.asarray(tg.degrees().astype(np.int32))
    wg = _wg(tg)
    key = jax.random.PRNGKey(seed)
    prev = cur = _t(starts)
    got = [cur]
    for _ in range(length):
        key, sub = jax.random.split(key)
        c = jnp.asarray(cur.numpy().astype(np.int32))
        dmax = jnp.maximum(deg[c], 1)
        k1, k2 = jax.random.split(sub)
        k0, k1 = jax.random.split(k1)
        r0 = jax.random.randint(k0, c.shape, 0, dmax)
        rs, us, k = [], [], k2
        for _ in range(EMB.REJECTION_ROUNDS):
            k, ka, kb = jax.random.split(k, 3)
            rs.append(_t(jax.random.randint(ka, c.shape, 0, dmax)))
            us.append(torch.from_numpy(np.array(
                jax.random.uniform(kb, c.shape))))
        prev, cur = cur, EMB._node2vec_step(wg, prev, cur, _t(r0), rs, us,
                                            p=p, q=q)
        got.append(cur)
    return torch.stack(got, 1).numpy(), want


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 4.0), (4.0, 0.5)])
def test_node2vec_step_on_jax_draws_equals_jax(name, p, q):
    jg, tg = _pair(GRAPHS[name])
    starts = np.tile(np.arange(tg.nv, dtype=np.int32), 2)
    if _jax_fails_on_edgeless(name, lambda: JEMB.node2vec_walks(
            jg, starts, 5, p=p, q=q, seed=11)):
        walks = EMB.node2vec_walks(tg, starts, 5, p=p, q=q, seed=11,
                                   device="cpu")
        assert (walks == starts[:, None]).all()
        return
    got, want = _node2vec_on_jax_draws(jg, tg, starts, 5, p, q, 11)
    assert np.array_equal(got, want)


def test_in_row_is_membership():
    _, tg = _pair(GRAPHS["selfloops"])
    wg = _wg(tg)
    rng = np.random.default_rng(0)
    v = rng.integers(0, tg.nv, 3000)
    x = rng.integers(0, tg.nv, 3000)
    src, dst = tg.coo()
    edges = set(zip(src.tolist(), dst.tolist()))
    # half the queries on real edges
    e = rng.integers(0, tg.ne, 1500)
    v[:1500], x[:1500] = src[e], dst[e]
    want = np.array([(a, b) in edges for a, b in zip(v, x)])
    assert np.array_equal(EMB._in_row(wg, _t(v), _t(x)).numpy(), want)


def _edges_are_edges(g, src, dst) -> None:
    """Every (src, dst) an edge of g, or a self-edge at a vertex without
    neighbours."""
    s, d = g.coo()
    edges = set(zip(s.tolist(), d.tolist()))
    deg = g.degrees()
    for a, b in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        assert (a, b) in edges or (a == b and deg[a] == 0), (a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_port_samples_and_walks_are_edges(name):
    _, tg = _pair(GRAPHS[name])
    seeds = np.arange(min(30, tg.nv))
    hops = KHOP.khop_sample(tg, seeds, (4, 3), seed=1, device="cpu")
    assert [len(s) for s, _ in hops] == [len(seeds) * 4, len(seeds) * 12]
    frontier = seeds
    for s, d in hops:
        assert s.dtype == d.dtype == np.int32
        assert np.array_equal(np.unique(s), np.unique(frontier))
        _edges_are_edges(tg, s, d)
        frontier = d
    starts = np.arange(tg.nv)
    for walks in (KHOP.random_walk(tg, starts, 5, seed=2, device="cpu"),
                  EMB.node2vec_walks(tg, starts, 5, p=0.5, q=2.0, seed=2,
                                     device="cpu")):
        assert walks.shape == (tg.nv, 6) and walks.dtype == np.int32
        assert np.array_equal(walks[:, 0], starts)
        _edges_are_edges(tg, walks[:, :-1].ravel(), walks[:, 1:].ravel())
        stalled = tg.degrees()[walks[:, 0]] == 0
        assert (walks[stalled] == walks[stalled, :1]).all()
    # one seed draws the same samples again, another others
    again = KHOP.khop_sample(tg, seeds, (4, 3), seed=1, device="cpu")
    assert all(np.array_equal(a[1], b[1]) for a, b in zip(hops, again))


# ---- skip-gram --------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 3, 9])
def test_skipgram_pairs_bit_equal(window):
    walks = np.random.default_rng(0).integers(0, 50, (20, 6)).astype(np.int32)
    for a, b in zip(EMB._skipgram_pairs(walks, window),
                    JEMB._skipgram_pairs(walks, window)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _jax_negatives(nv, n_pairs, batch, epochs, neg, seed):
    """The negatives JAX's train_skipgram draws, by (epoch, step)."""
    batch = max(256, min(batch, n_pairs, 8 * nv))
    steps = -(-n_pairs // batch)
    out = {}
    for ep in range(epochs):
        key = jax.random.PRNGKey(seed + ep)
        for s in range(steps):
            key, sub = jax.random.split(key)
            out[ep, s] = torch.from_numpy(np.asarray(
                jax.random.randint(sub, (batch, neg), 0, nv)).astype(np.int64))
    return out


@pytest.mark.parametrize("dim,batch", [(16, 65536), (8, 300)])
def test_train_skipgram_on_jax_negatives_equals_jax(dim, batch):
    _, tg = _pair(GRAPHS["rmat10"])
    walks = JKHOP.random_walk(tg, np.tile(np.arange(tg.nv), 2), 6, seed=0)
    c, o = EMB._skipgram_pairs(np.asarray(walks), 2)
    kw = dict(dim=dim, epochs=3, neg=5, lr=0.025, batch=batch, seed=4)
    want = JEMB.train_skipgram(tg.nv, c, o, **kw)
    negs = _jax_negatives(tg.nv, len(c), batch, 3, 5, 4)
    got = EMB._train_skipgram(tg.nv, c, o, lambda ep, s, shape: negs[ep, s],
                              device="cpu", **kw)
    assert got.shape == want.shape == (tg.nv, dim)
    np.testing.assert_allclose(got, want, **SKIPGRAM)


def test_deepwalk_and_node2vec_are_finite():
    _, tg = _pair(GRAPHS["disconnected"])
    for fn in (EMB.deepwalk, EMB.node2vec):
        emb = fn(tg, dim=8, walks_per_vertex=2, walk_length=5, epochs=2,
                 device="cpu")
        assert emb.shape == (tg.nv, 8) and emb.dtype == np.float32
        assert np.isfinite(emb).all()
        # the walks moved the embeddings off numpy's initial draw
        init = ((np.random.default_rng(0).random((tg.nv, 8)) - 0.5)
                .astype(np.float32) / 8)
        assert not np.array_equal(emb, init)


# ---- the CLI routes -----------------------------------------------------------

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


def _cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("GAB_SHARDS", None)
    return subprocess.run(
        [sys.executable, "-m", "graphaibench_tpu_torch.cli", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def _lines(out: str) -> list[str]:
    """What a run prints, without its runtime and its device, and without
    the embeddings' mean norm, which depends on the draws."""
    return [l.split(", mean norm")[0] for l in out.splitlines()
            if not l.startswith(("runtime = ", "device = "))]


@pytest.mark.parametrize("ds", ["sym", "dir"])
@pytest.mark.parametrize("kernel,args", [("color", []), ("cf", []),
                                         ("sample", []),
                                         ("embed", ["deepwalk", "16"]),
                                         ("embed", ["node2vec", "8"])])
def test_cli_routes_print_what_the_jax_route_prints(datasets, kernel, args,
                                                    ds, capsys):
    """``cli analytics <k> <dir> --device=cpu``: exit 0 with ``Correct``,
    and JAX's ``run_benchmark``'s lines and exit code, apart from the
    runtime, the device and the embeddings' mean norm."""
    r = _cli("analytics", kernel, datasets[ds], *args, "--device=cpu")
    lines = r.stdout.splitlines()
    assert "device = cpu" in lines
    assert sum(l.startswith("runtime = ") for l in lines) == 1
    capsys.readouterr()
    rc = JA.run_benchmark(kernel, datasets[ds], args)
    assert r.returncode == rc, r.stderr
    assert _lines(r.stdout) == _lines(capsys.readouterr().out)
    if ds == "sym" or kernel != "color":
        assert r.returncode == 0 and "Correct" in lines, r.stdout + r.stderr


def test_run_benchmark_routes_in_process(datasets, capsys):
    for kernel in ("color", "sample"):
        assert run_benchmark(kernel, datasets["sym"], [], device="cpu") == 0
        out = capsys.readouterr().out.splitlines()
        assert "Correct" in out and "device = cpu" in out
