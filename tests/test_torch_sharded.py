"""The port's sharded trainer against the JAX package's, on the CPU.

1. The ranks' local ops in one process, on given tables: ``slot_spmm_packed``
   (forward and x-adjoint) and ``gat_fused_local_v2`` (output and its three
   gradients, the backward in two passes and in one) against the JAX
   package's functions on that shard's slice of its stacked layout.
2. ``halo_exchange`` forward and backward over gloo ranks against a numpy
   reference of the plan: 2 ranks, and 3 ranks where an owned row is sent
   to two peers; in both the padded halo is larger than the real one.
   ``make_sharded_spmm``'s three routes against the single-device SpMM.
3. The trainer over 2 gloo ranks against JAX's ``make_sharded_trainer`` on
   a 2-device CPU mesh and against the port's ``Model``, for gcn, sage,
   gat (l2norm and dense head) and ggnn on the graph of
   tests/test_parallel.py::test_sharded_training_matches_single_device,
   with its bounds: logits at the initial weights rtol 1e-4, atol 1e-5; 3
   step losses within 2e-4 (ggnn 1e-3); W_neigh within 3 lr. Also
   balance="edge", overlap=False and use_ell=False, and gcn over 3 ranks.
   Both ranks must hold identical parameters.
4. The CLI's ``GAB_SHARDS=2 ... --device=cpu`` route, and its refusal of
   GGNN under ``GAB_TP``.

The ranks are spawned processes that import this module, so jax is
imported inside the tests only. Each spawn runs all of its cases at once
(a module fixture) and has its own time limit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphaibench_tpu_torch.graph import transforms as tT
from graphaibench_tpu_torch.graph.generators import rmat, uniform_random
from graphaibench_tpu_torch.graph.io import GnnDataset, Meta, save_graph
from graphaibench_tpu_torch.nn import Model
from graphaibench_tpu_torch.nn.layers import ModelConfig, apply_model, init_params
from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
from graphaibench_tpu_torch.ops import fused_gat as tfg
from graphaibench_tpu_torch.ops.device_graph import to_device_graph
from graphaibench_tpu_torch.ops.spmm import spmm_coo
from graphaibench_tpu_torch.parallel import halo as thalo
from graphaibench_tpu_torch.parallel import multihost
from graphaibench_tpu_torch.parallel import partition as tpart
from graphaibench_tpu_torch.parallel import shard_ell as tse
from graphaibench_tpu_torch.parallel.train import make_sharded_trainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240
TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_torch_fused_gat.py's tolerances for the fused attention
VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _local_graph(gen):
    """rmat(9, 8) with self-loops and its GCN norms, in either package."""
    g = gen.add_selfloop(gen.rmat(9, 8, seed=3))
    return g, gen.gcn_edge_norms(g)


class _Port:
    rmat = staticmethod(rmat)
    add_selfloop = staticmethod(tT.add_selfloop)
    gcn_edge_norms = staticmethod(tT.gcn_edge_norms)


def _jax_side():
    import jax  # noqa: F401  (the spawned ranks never import it)

    from graphaibench_tpu.graph import generators as jgen
    from graphaibench_tpu.graph import transforms as jT
    from graphaibench_tpu.parallel import partition as jpart
    from graphaibench_tpu.parallel import shard_ell as jse

    class Jax:
        rmat = staticmethod(jgen.rmat)
        add_selfloop = staticmethod(jT.add_selfloop)
        gcn_edge_norms = staticmethod(jT.gcn_edge_norms)

    return Jax, jpart, jse


def _shard(tree, rank):
    import jax

    return jax.tree.map(lambda a: a[rank], tree)


# ---- 1. the local ops, one process ------------------------------------------

@pytest.mark.parametrize("part", ["own", "halo", "all"])
@pytest.mark.parametrize("rank", [0, 1])
def test_slot_spmm_packed_matches_jax(rank, part):
    import jax
    import jax.numpy as jnp

    Jax, jpart, jse = _jax_side()
    jg, w = _local_graph(Jax)
    tg, _ = _local_graph(_Port)
    jsg = jpart.build_sharded_graph(jg, w, 2)
    sg = tpart.build_sharded_graph(tg, w, 2)
    jl = jse.build_shard_ell(jsg, part=part)
    jwp = jse.pack_shard_values(jl, jsg.edge_w)
    se = tse.build_shard_ell(sg.shard(rank), part=part)
    wp = tse.pack_shard_values(se, torch.from_numpy(sg.edge_w[rank]))
    if part == "halo":
        assert se.fwd.has_ell_layout     # the case has halo edges
    rng = np.random.default_rng(rank)
    x = rng.standard_normal((se.fwd.n_cols, 24)).astype(np.float32)
    ct = rng.standard_normal((sg.nv_pad, 24)).astype(np.float32)
    def value_and_vjp(a, d):
        out, vjp = jax.vjp(lambda x_: jse.slot_spmm_packed(
            sg.nv_pad, _shard(jl, rank), _shard(jwp, rank), x_), a)
        return out, vjp(d)[0]

    out, dx = jax.jit(value_and_vjp)(jnp.asarray(x), jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    got = tse.slot_spmm_packed(sg.nv_pad, se, wp, xt)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **TOL)


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
def test_gat_fused_local_v2_matches_jax(rank, single, monkeypatch):
    """Output and the gradients of sl, sr_ext and h_ext; the backward's
    transpose role runs on the transpose table (single: the one pass that
    adds d_sl by neighbour, else gat_v2_bwd_sl on the forward table)."""
    import jax
    import jax.numpy as jnp

    Jax, jpart, jse = _jax_side()
    jg, _ = _local_graph(Jax)
    tg, _ = _local_graph(_Port)
    ones = np.ones(jg.ne, np.float32)
    jsg = jpart.build_sharded_graph(jg, ones, 2)
    sg = tpart.build_sharded_graph(tg, ones, 2)
    jl = _shard(jse.build_shard_ell(jsg), rank)
    se = tse.build_shard_ell(sg.shard(rank))
    if rank == 0:   # a hub's pieces are combined, forward and transpose
        assert int(se.fwd.is_split.sum()) > 0
        assert int(se.trans.is_split.sum()) > 0
    n_ext = sg.nv_pad + sg.h_max
    rng = np.random.default_rng(10 + rank)
    sl = rng.standard_normal(sg.nv_pad).astype(np.float32)
    sr = rng.standard_normal(n_ext).astype(np.float32)
    h = rng.standard_normal((n_ext, 16)).astype(np.float32)
    ct = rng.standard_normal((sg.nv_pad, 16)).astype(np.float32)
    def value_and_vjp(a, b, c, d):
        out, vjp = jax.vjp(lambda *x: jse.gat_fused_local_v2(
            sg.nv_pad, jl, *x), a, b, c)
        return out, vjp(d)

    # jitted: one compile instead of one per eager op and shape
    out, want = jax.jit(value_and_vjp)(*map(jnp.asarray, (sl, sr, h, ct)))
    monkeypatch.setattr(tfg, "_single_pass", lambda nv, f: single)
    ins = [torch.tensor(a, requires_grad=True) for a in (sl, sr, h)]
    got = tse.gat_fused_local_v2(sg.nv_pad, se, *ins)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **VAL)
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD)


# ---- 2./3. the ranks ------------------------------------------------------

def _trainer_data():
    """tests/test_parallel.py::test_sharded_training_matches_single_device."""
    g = uniform_random(240, 700, seed=5)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((g.nv, 12)).astype(np.float32)
    labels = rng.integers(0, 5, g.nv).astype(np.int32)
    mask = np.ones(g.nv, dtype=np.uint8)
    return g, feats, labels, mask, (0, 120, 120)


def _cfg(arch):
    kw = dict(use_l2norm=True, use_dense=True) if arch == "gat" else {}
    return ModelConfig(arch=arch, num_layers=2, dim_init=12, dim_hid=8,
                       num_cls=5, lr=0.02, **kw)


# name -> (arch, build_sharded_graph kwargs, trainer kwargs, ranks)
TRAINER_CASES = {
    "gcn": ("gcn", {}, {}, 2),
    "sage": ("sage", {}, {}, 2),
    "gat": ("gat", {}, {}, 2),
    "ggnn": ("ggnn", {}, {}, 2),
    "gcn_balance_edge": ("gcn", {"balance": "edge"}, {}, 2),
    "sage_no_overlap": ("sage", {}, {"overlap": False}, 2),
    "gat_plain_route": ("gat", {}, {"use_ell": False}, 2),
    "gcn_3_ranks": ("gcn", {}, {}, 3),
}
STEPS = 3


def _halo_inputs(sg, rank, f=6):
    """A rank's owned rows, and a cotangent on its real halo rows (a pad
    row's is zero, as it is in training: no edge reads it)."""
    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal((sg.nv_pad, f)).astype(np.float32)
    ct = rng.standard_normal((sg.h_max, f)).astype(np.float32)
    ct[sg.halo_counts[rank]:] = 0.0
    return x, ct


def _halo_reference(sg, f=6):
    """The plan in numpy: halo row k of rank p is row
    send_idx[q, p, pos] of rank q, where halo_map[p, k] = q s_max + pos;
    the backward adds the halo rows' cotangents into those rows."""
    ins = [_halo_inputs(sg, r, f) for r in range(sg.num_shards)]
    out = np.zeros((sg.num_shards, sg.h_max, f), np.float32)
    dx = np.zeros((sg.num_shards, sg.nv_pad, f), np.float64)
    for p in range(sg.num_shards):
        for k in range(sg.h_max):
            q, pos = divmod(int(sg.halo_map[p, k]), sg.s_max)
            row = sg.send_idx[q, p, pos]
            out[p, k] = ins[q][0][row]
            dx[q, row] += ins[p][1][k]
    return out, dx


def _halo_graph(n):
    g = tT.add_selfloop(uniform_random(240, 700, seed=5))
    return tpart.build_sharded_graph(g, tT.gcn_edge_norms(g), n), g


def _rank_cases(rank, n):
    """What each rank of a spawn computes: the halo exchange, the sharded
    SpMM's routes (2 ranks) and the trainer cases of ``n`` ranks."""
    torch.set_num_threads(1)
    res = {}
    sg, g = _halo_graph(n)
    x, ct = _halo_inputs(sg, rank)
    xt = torch.tensor(x, requires_grad=True)
    halo = thalo.halo_exchange(xt, torch.from_numpy(sg.send_idx[rank]),
                               torch.from_numpy(sg.halo_map[rank]))
    halo.backward(torch.from_numpy(ct))
    res["halo"] = (halo.detach().numpy(), xt.grad.numpy())
    if n == 2:
        own = torch.from_numpy(tpart.pad_rows(
            np.random.default_rng(7).standard_normal((g.nv, 5)).astype(
                np.float32), sg.padded_nv)[rank * sg.nv_pad:
                                           (rank + 1) * sg.nv_pad])
        res["spmm"] = {
            str(kw): thalo.make_sharded_spmm(sg, rank, **kw)(own).numpy()
            for kw in ({}, {"overlap": False}, {"use_ell": False})}
    g, feats, labels, mask, tr = _trainer_data()
    for name, (arch, sg_kw, tr_kw, ranks) in TRAINER_CASES.items():
        if ranks != n:
            continue
        cfg = _cfg(arch)
        gp = prepare_graph(g, arch)
        sg = tpart.build_sharded_graph(gp, aggregation_weights(gp, arch), n,
                                       **sg_kw)
        trainer = make_sharded_trainer(cfg, sg, feats, labels, tr, mask,
                                       **tr_kw)
        params = init_params(cfg, device="cpu")
        opt = OPTIMIZERS[cfg.optimizer](params.parameters(), lr=cfg.lr)
        logits0 = trainer.eval_logits(params).numpy()
        losses = [float(trainer.train_step(params, opt)) for _ in range(STEPS)]
        res[name] = dict(logits0=logits0, losses=losses,
                         params={k: p.detach().numpy().copy()
                                 for k, p in params.named_parameters()})
    return res


@pytest.fixture(scope="module")
def ranks2():
    return multihost.launch(_rank_cases, 2, timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks3():
    return multihost.launch(_rank_cases, 3, timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("n", [2, 3])
def test_halo_exchange_matches_numpy(n, ranks2, ranks3):
    res = {2: ranks2, 3: ranks3}[n]
    sg, _ = _halo_graph(n)
    assert (sg.h_max > sg.halo_counts).all()     # the halo has pad rows
    if n == 3:   # an owned row in the send lists of two peers
        assert any(
            len(np.unique(ids)) < len(ids) for ids in (
                np.concatenate([_send_list(sg, q, p) for p in range(n)
                                if p != q]) for q in range(n)))
    out, dx = _halo_reference(sg)
    for r in range(n):
        halo, grad = res[r]["halo"]
        np.testing.assert_array_equal(halo, out[r])
        np.testing.assert_allclose(grad, dx[r], rtol=1e-6, atol=1e-6)


def _send_list(sg, q, p):
    """The owned rows rank q really sends to rank p: those that some
    halo row of p reads from q."""
    slots = sg.halo_map[p, :sg.halo_counts[p]]
    pos = slots[slots // sg.s_max == q] % sg.s_max
    return sg.send_idx[q, p, pos]


@pytest.mark.parametrize("route", ["{}", "{'overlap': False}",
                                   "{'use_ell': False}"])
def test_sharded_spmm_routes_match_single(ranks2, route):
    sg, g = _halo_graph(2)
    x = np.random.default_rng(7).standard_normal((g.nv, 5)).astype(np.float32)
    want = spmm_coo(to_device_graph(g, device="cpu"),
                    torch.from_numpy(tT.gcn_edge_norms(g)),
                    torch.from_numpy(x)).numpy()
    got = np.concatenate([ranks2[r]["spmm"][route] for r in range(2)])
    np.testing.assert_allclose(got[:g.nv], want, rtol=1e-5, atol=1e-5)


def _jax_trainer_run(arch, sg_kw, tr_kw):
    import jax
    from jax.sharding import Mesh

    from graphaibench_tpu.nn import layers as jl
    from graphaibench_tpu.nn.model import aggregation_weights as jaw
    from graphaibench_tpu.nn.model import prepare_graph as jprep
    from graphaibench_tpu.nn.optim import Adam
    from graphaibench_tpu.graph import generators as jgen
    from graphaibench_tpu.parallel import AXIS, build_sharded_graph
    from graphaibench_tpu.parallel import make_sharded_trainer as jmake

    g, feats, labels, mask, tr = _trainer_data()
    jg = jprep(jgen.uniform_random(240, 700, seed=5), arch)
    cfg = jl.ModelConfig(**{k: getattr(_cfg(arch), k) for k in (
        "arch", "num_layers", "dim_init", "dim_hid", "num_cls", "lr",
        "use_l2norm", "use_dense")})
    mesh = Mesh(np.array(jax.devices()[:2]), (AXIS,))
    sg = build_sharded_graph(jg, jaw(jg, arch), 2, **sg_kw)
    trainer = jmake(mesh, cfg, sg, feats, labels, tr, mask, **tr_kw)
    params = jl.init_params(cfg)
    opt_state = Adam(lr=cfg.lr).init(params)
    logits0 = np.asarray(trainer.eval_logits(params))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = trainer.train_step(params, opt_state)
        losses.append(float(loss))
    w = [np.asarray(layer["W_neigh"]) for layer in params["gconv"]]
    return logits0, losses, w


def _model_run(arch):
    g, feats, labels, mask, tr = _trainer_data()
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=5,
                    train_range=tr, val_range=tr, test_range=tr)
    m = Model(_cfg(arch), ds, device="cpu")
    with torch.no_grad():
        logits0 = apply_model(m.cfg, m.params, m.full.device,
                              m.full.edge_w_agg, m.feats,
                              trivial_w=True).numpy()
    losses = [m.train_epoch()[0] for _ in range(STEPS)]
    return logits0, losses, [layer.W_neigh.detach().numpy()
                             for layer in m.params.gconv]


@pytest.mark.parametrize("name", sorted(TRAINER_CASES))
def test_trainer_matches_jax_and_model(name, ranks2, ranks3):
    arch, sg_kw, tr_kw, n = TRAINER_CASES[name]
    res = {2: ranks2, 3: ranks3}[n]
    ours = res[0][name]
    for r in range(1, n):   # the summed gradients keep the ranks in step
        assert res[r][name]["losses"] == ours["losses"]
        for k, a in res[r][name]["params"].items():
            np.testing.assert_array_equal(a, ours["params"][k])
        np.testing.assert_array_equal(res[r][name]["logits0"], ours["logits0"])
    refs = {"model": _model_run(arch)}
    if n == 2:
        refs["jax"] = _jax_trainer_run(arch, sg_kw, tr_kw)
    # ggnn's GRU gates amplify float32 summation-order noise over the steps
    tol = 1e-3 if arch == "ggnn" else 2e-4
    lr = _cfg(arch).lr
    w_ours = [ours["params"][f"gconv.{l}.W_neigh"] for l in range(2)]
    for what, (logits0, losses, w) in refs.items():
        np.testing.assert_allclose(ours["logits0"], logits0, rtol=1e-4,
                                   atol=1e-5, err_msg=what)
        assert np.abs(np.array(ours["losses"]) - losses).max() < tol, (
            what, ours["losses"], losses)
        for a, b in zip(w_ours, w):
            np.testing.assert_allclose(a, b, atol=3 * lr, err_msg=what)


def _fail_on_rank_1(rank, n):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()     # rank 0 waits on a peer that will not come


def test_launch_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="on purpose"):
        multihost.launch(_fail_on_rank_1, 2, timeout_s=SPAWN_TIMEOUT_S)


# ---- 4. the CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rmat9"))
    g = rmat(9, 8, seed=0)
    save_graph(g, path, meta=Meta(nv=g.nv, ne=g.ne, num_vertex_classes=4,
                                  train=(0, 256, 256), val=(256, 384, 128),
                                  test=(384, 512, 128)))
    return path


def _cli(*args, **env):
    full = dict(os.environ, OMP_NUM_THREADS="1", **env)
    for name in ("GAB_SHARDS", "GAB_TP", "GAB_DP"):
        if name not in env:
            full.pop(name, None)
    return subprocess.run(
        [sys.executable, "-m", "graphaibench_tpu_torch.cli", *args],
        cwd=REPO, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S,
        env=full)


ARGV = ("5", "0", "softmax", "16", "0", "0", "0.02", "2", "0", "2")


def test_cli_sharded_route(dataset):
    """The JAX CLI's sharded lines, val_acc after epochs 2 and 4
    (tests/test_parallel.py::test_train_cli_sharded_val_acc), the halo
    row under --timers, and the losses of the single-device route."""
    r = _cli("train", "gcn", dataset, *ARGV, "--device=cpu", "--timers",
             GAB_SHARDS="2")
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert ("sharded trainer: 2 rank(s), vertex-sharded halo exchange, "
            "backend gloo, halo transport device") in out
    epochs = [l for l in out.splitlines() if l.startswith("Epoch")]
    assert [l.split(":")[0] for l in epochs] == [
        f"Epoch {e:3d}" for e in range(5)]
    assert [l.split(":")[0] for l in epochs if "val_acc" in l] == [
        "Epoch   2", "Epoch   4"]
    assert "time per epoch:" in out
    acc = float(out.split("Test accuracy:", 1)[1].split()[0])
    assert 0.0 <= acc <= 1.0
    assert any(l.split()[:1] == ["halo"] for l in out.splitlines())
    single = _cli("train", "gcn", dataset, *ARGV, "--device=cpu")
    assert single.returncode == 0, single.stderr
    want = [float(l.split("train_loss")[1].split()[0])
            for l in single.stdout.splitlines() if l.startswith("Epoch")]
    got = [float(l.split("train_loss = ")[1].split()[0]) for l in epochs]
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_cli_sharded_refusals(dataset):
    """GGNN has no tensor-parallel forward (JAX asserts): exit 2."""
    r = _cli("train", "ggnn", dataset, "1", "--device=cpu", GAB_SHARDS="2",
             GAB_TP="2")
    assert r.returncode == 2 and "ggnn" in r.stderr and "Epoch" not in r.stdout
    if not torch.cuda.is_available():   # no fallback to the CPU
        r = _cli("train", "gcn", dataset, "1", GAB_SHARDS="2")
        assert r.returncode != 0 and "Epoch" not in r.stdout
