"""The port's tensor-parallel trainer against the JAX package's and
against the truth, on the CPU.

1. ``make_tp_trainer`` over 8 gloo ranks on the cases of
   tests/test_parallel.py::test_tp_trainer_matches_single_device ((G
   graph x M model) grids (2 x 4) and (4 x 2), gcn, sage and gat, ragged
   widths among them), held to JAX's ``make_tp_trainer`` on an 8-device
   CPU mesh and to the port's ``Model``: the logits at the initial
   weights within rtol 1e-4, atol 1e-5; the losses of 3 Adam steps within
   2e-4; the masked accuracy within 1e-6; and the gradients of the first
   step, summed over the ranks, to ``Model``'s gradients leaf by leaf
   within rtol 1e-4, atol 1e-6 (Adam divides a constant factor out of a
   gradient, so its losses alone would not show one). Every rank holds
   the same losses, gradients and parameters.
2. The factor JAX's sharded trainers carry: under ``shard_map`` with
   ``check_vma=False`` their SGD updates are G (1-D trainer) and G x M
   (tensor-parallel) times ``Model``'s: the step over that factor is
   Model's gradient step within rtol 1e-4, atol 1e-6 on the gradient;
   this test fails if JAX's behaviour changes. Beside it the port's 1-D
   and tensor-parallel trainers, whose SGD steps are Model's within the
   same tolerance.
3. The CLI's ``GAB_SHARDS=4 GAB_TP=2 ... --device=cpu`` route, its
   refusal of GGNN, and no fallback to the CPU without a card.

The ranks are spawned processes that import this module, so jax is
imported inside the tests only. One spawn runs every case.
"""

import numpy as np
import pytest
import torch

from graphaibench_tpu_torch.graph.generators import uniform_random
from graphaibench_tpu_torch.graph.io import GnnDataset
from graphaibench_tpu_torch.nn import Model, make_config
from graphaibench_tpu_torch.nn.layers import (
    ModelConfig,
    apply_model,
    init_params,
    leaves_in_param_order,
)
from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
from graphaibench_tpu_torch.parallel import multihost
from graphaibench_tpu_torch.parallel import partition as tpart
from graphaibench_tpu_torch.parallel.train import (
    make_sharded_trainer,
    make_tp_trainer,
)

from test_torch_sharded import _cli, dataset  # noqa: F401  (a fixture)

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 240
RANKS = 8
STEPS = 3
# name -> ((G, M), arch, (dim_init, dim_hid)): tests/test_parallel.py:441-448
TP_CASES = {
    "gcn_2x4": ((2, 4), "gcn", (16, 8)),
    "sage_4x2": ((4, 2), "sage", (16, 8)),
    "sage_2x4": ((2, 4), "sage", (16, 8)),
    "gcn_2x4_ragged": ((2, 4), "gcn", (18, 7)),   # neither dim divides M
    "gat_2x4": ((2, 4), "gat", (16, 8)),           # l2norm and dense head
    "gat_4x2_ragged": ((4, 2), "gat", (18, 7)),
}
# the port's SGD steps: name -> (G, M, arch, dims); M = 1 is the 1-D trainer
SGD_CASES = {
    "1d_8": (8, 1, "gcn", (16, 8)),
    "tp_2x4_gcn": (2, 4, "gcn", (16, 8)),
    "tp_4x2_gat": (4, 2, "gat", (18, 7)),
}


def _data(f_in):
    """tests/test_parallel.py's graph and data."""
    g = uniform_random(240, 700, seed=5)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((g.nv, f_in)).astype(np.float32)
    labels = rng.integers(0, 5, g.nv).astype(np.int32)
    mask = np.ones(g.nv, dtype=np.uint8)
    return g, feats, labels, mask, (0, 120, 120)


# the SGD steps' rate: a step of 1 reads the gradient off the parameters
# with float32's rounding of the parameters, not that over a small rate
SGD_LR = 1.0


def _cfg(arch, dims, optimizer="adam"):
    kw = dict(use_l2norm=True, use_dense=True) if arch == "gat" else {}
    return ModelConfig(arch=arch, num_layers=2, dim_init=dims[0],
                       dim_hid=dims[1], num_cls=5,
                       lr=SGD_LR if optimizer == "sgd" else 0.02,
                       optimizer=optimizer, **kw)


def _grads(params) -> dict:
    return {k: p.grad.numpy().copy() for k, p in params.named_parameters()}


def _params(params) -> dict:
    return {k: p.detach().numpy().copy() for k, p in params.named_parameters()}


def _rank_cases(rank, n):
    """Every case on one rank: the TP cases' logits, accuracy, losses,
    first-step gradients and final parameters, then the SGD cases'
    updates."""
    torch.set_num_threads(1)
    res = {}
    for name, ((G, M), arch, dims) in TP_CASES.items():
        g, feats, labels, mask, tr = _data(dims[0])
        cfg = _cfg(arch, dims)
        gp = prepare_graph(g, arch)
        sg = tpart.build_sharded_graph(gp, aggregation_weights(gp, arch), G)
        trainer = make_tp_trainer(cfg, sg, feats, labels, tr, mask,
                                  model_parallelism=M,
                                  eval_ranges={"val": (tr, mask)})
        params = init_params(cfg, device="cpu")
        opt = OPTIMIZERS["adam"](params.parameters(), lr=cfg.lr)
        out = dict(logits0=trainer.eval_logits(params).numpy(),
                   acc0=trainer.eval_accuracy(params, "val"), losses=[])
        for step in range(STEPS):
            out["losses"].append(float(trainer.train_step(params, opt)))
            if step == 0:
                out["grads"] = _grads(params)
        out["params"] = _params(params)
        res[name] = out
    for name, (G, M, arch, dims) in SGD_CASES.items():
        g, feats, labels, mask, tr = _data(dims[0])
        cfg = _cfg(arch, dims, "sgd")
        gp = prepare_graph(g, arch)
        sg = tpart.build_sharded_graph(gp, aggregation_weights(gp, arch), G)
        if M == 1:
            trainer = make_sharded_trainer(cfg, sg, feats, labels, tr, mask)
        else:
            trainer = make_tp_trainer(cfg, sg, feats, labels, tr, mask,
                                      model_parallelism=M)
        params = init_params(cfg, device="cpu")
        trainer.train_step(params, OPTIMIZERS["sgd"](params.parameters(),
                                                     lr=cfg.lr))
        res[name] = _params(params)
    return res


@pytest.fixture(scope="module")
def ranks():
    return multihost.launch(_rank_cases, RANKS, timeout_s=SPAWN_TIMEOUT_S)


def _model(arch, dims, optimizer="adam"):
    g, feats, labels, mask, tr = _data(dims[0])
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=5,
                    train_range=tr, val_range=tr, test_range=tr)
    return Model(_cfg(arch, dims, optimizer), ds, device="cpu")


def _model_run(arch, dims):
    """Model's logits at the initial weights, validation accuracy, the
    first step's gradients and the losses of STEPS steps."""
    m = _model(arch, dims)
    with torch.no_grad():
        logits0 = apply_model(m.cfg, m.params, m.full.device,
                              m.full.edge_w_agg, m.feats,
                              trivial_w=True).numpy()
    acc0 = m.evaluate("val")
    losses = [m.train_epoch()[0]]
    grads = _grads(m.params)
    losses += [m.train_epoch()[0] for _ in range(STEPS - 1)]
    return logits0, acc0, losses, grads


def _jax_cfg(arch, dims, optimizer="adam"):
    from graphaibench_tpu.nn import layers as jl

    c = _cfg(arch, dims, optimizer)
    return jl.ModelConfig(**{k: getattr(c, k) for k in (
        "arch", "num_layers", "dim_init", "dim_hid", "num_cls", "lr",
        "use_l2norm", "use_dense", "optimizer")})


def _jax_trainer(shape, arch, dims, optimizer="adam"):
    """JAX's 1-D (shape (G,)) or tensor-parallel (shape (G, M)) trainer on
    the virtual CPU devices, with its initial parameters."""
    import jax
    from jax.sharding import Mesh

    from graphaibench_tpu.graph import generators as jgen
    from graphaibench_tpu.nn import layers as jl
    from graphaibench_tpu.nn.model import aggregation_weights as jaw
    from graphaibench_tpu.nn.model import prepare_graph as jprep
    from graphaibench_tpu.parallel import (
        AXIS,
        MODEL_AXIS,
        build_sharded_graph,
        make_sharded_trainer as jmake,
        make_tp_trainer as jmake_tp,
    )

    _, feats, labels, mask, tr = _data(dims[0])
    jg = jprep(jgen.uniform_random(240, 700, seed=5), arch)
    cfg = _jax_cfg(arch, dims, optimizer)
    sg = build_sharded_graph(jg, jaw(jg, arch), shape[0])
    devs = np.array(jax.devices()[:int(np.prod(shape))])
    if len(shape) == 1:
        trainer = jmake(Mesh(devs, (AXIS,)), cfg, sg, feats, labels, tr,
                        mask, optimizer=optimizer)
    else:
        trainer = jmake_tp(Mesh(devs.reshape(shape), (AXIS, MODEL_AXIS)),
                           cfg, sg, feats, labels, tr, mask,
                           optimizer=optimizer)
    return trainer, jl.init_params(cfg)


def _jax_run(shape, arch, dims):
    from graphaibench_tpu.nn.optim import Adam

    trainer, params = _jax_trainer(shape, arch, dims)
    opt_state = Adam(lr=0.02).init(params)
    logits0 = np.asarray(trainer.eval_logits(params))
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = trainer.train_step(params, opt_state)
        losses.append(float(loss))
    return logits0, losses


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_trainer_matches_jax_and_model(name, ranks):
    (G, M), arch, dims = TP_CASES[name]
    ours = ranks[0][name]
    for r in range(1, RANKS):   # the summed gradients keep the ranks in step
        theirs = ranks[r][name]
        assert theirs["losses"] == ours["losses"]
        np.testing.assert_array_equal(theirs["logits0"], ours["logits0"])
        for what in ("grads", "params"):
            for k, a in theirs[what].items():
                np.testing.assert_array_equal(a, ours[what][k],
                                              err_msg=f"rank {r} {what} {k}")
    logits0, acc0, losses, grads = _model_run(arch, dims)
    j_logits0, j_losses = _jax_run((G, M), arch, dims)
    for what, (lg, ls) in {"model": (logits0, losses),
                           "jax": (j_logits0, j_losses)}.items():
        np.testing.assert_allclose(ours["logits0"], lg, rtol=1e-4, atol=1e-5,
                                   err_msg=what)
        assert np.abs(np.array(ours["losses"]) - ls).max() < 2e-4, (
            what, ours["losses"], ls)
    assert abs(ours["acc0"] - acc0) < 1e-6
    # what Adam would hide: the gradient itself, leaf by leaf
    assert set(ours["grads"]) == set(grads)
    for k, want in grads.items():
        np.testing.assert_allclose(ours["grads"][k], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _as_gradient(after, before, factor=1) -> list:
    """Per leaf, the gradient an SGD step of SGD_LR from ``before`` to
    ``after`` took, divided by ``factor``."""
    return [(np.asarray(b) - np.asarray(a)) / (SGD_LR * factor)
            for a, b in zip(after, before)]


def _model_sgd_step(arch, dims) -> tuple[list, list]:
    """Model's parameters before and after one SGD step, in the order of
    ``GcnParams.parameters()``."""
    m = _model(arch, dims, "sgd")
    before = [p.detach().numpy().copy() for p in m.params.parameters()]
    m.train_epoch()
    return before, [p.detach().numpy().copy() for p in m.params.parameters()]


# name -> (mesh shape, arch, dims, JAX's factor: G or G x M)
JAX_FACTOR_CASES = {
    "1d_2_gcn": ((2,), "gcn", (16, 8), 2),
    "tp_2x4_gcn": ((2, 4), "gcn", (16, 8), 8),
    "tp_2x2_gat": ((2, 2), "gat", (16, 8), 4),
    "tp_2x2_sage": ((2, 2), "sage", (16, 8), 4),
}


@pytest.mark.parametrize("name", list(JAX_FACTOR_CASES))
def test_jax_sharded_sgd_update_is_a_multiple_of_models(name):
    """ROADMAP queue 3: JAX's sharded trainers step G (1-D) or G x M
    (tensor-parallel) times as far as the true gradient takes them: the
    step divided by that factor is Model's gradient step, leaf by leaf,
    within the gradient tolerance of the test above (rtol 1e-4, atol
    1e-6 on the gradient)."""
    from graphaibench_tpu.nn.optim import SGD

    shape, arch, dims, factor = JAX_FACTOR_CASES[name]
    trainer, params = _jax_trainer(shape, arch, dims, "sgd")
    before = [np.asarray(a) for a in leaves_in_param_order(params)]
    params, _, _ = trainer.train_step(params, SGD(lr=SGD_LR).init(params))
    m_before, m_after = _model_sgd_step(arch, dims)
    for a, b in zip(before, m_before):   # one initialization
        np.testing.assert_array_equal(a, b)
    want = _as_gradient(m_after, m_before)
    got = _as_gradient(leaves_in_param_order(params), m_before,
                       factor=factor)
    for l, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name} leaf {l}")
    # and not the true step: the factor is there
    np.testing.assert_allclose(
        np.linalg.norm(_as_gradient(leaves_in_param_order(params),
                                    m_before)[0]) / np.linalg.norm(want[0]),
        factor, rtol=1e-3)


@pytest.mark.parametrize("name", list(SGD_CASES))
def test_port_sharded_sgd_update_equals_models(name, ranks):
    G, M, arch, dims = SGD_CASES[name]
    before, after = _model_sgd_step(arch, dims)
    want = _as_gradient(after, before)
    for r in range(RANKS):
        got = _as_gradient(list(ranks[r][name].values()), before)
        for l, (a, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} rank {r} leaf {l}")


# ---- the CLI ------------------------------------------------------------

ARGV = ("5", "0", "softmax", "16", "0", "0", "0.02", "2", "0", "2")


def test_cli_tp_route(dataset):
    """(2 graph x 2 model) ranks: the JAX CLI's lines, and the test
    accuracy of Model trained alike."""
    from graphaibench_tpu_torch.graph.io import load_gnn_dataset

    r = _cli("train", "gcn", dataset, *ARGV, "--device=cpu",
             GAB_SHARDS="4", GAB_TP="2")
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert ("sharded trainer: (2 graph x 2 model) ranks, vertex sharding + "
            "feature-dim tensor parallelism, backend gloo, transport device, "
            "reduce-scatter reduce_scatter_tensor") in out
    epochs = [l for l in out.splitlines() if l.startswith("Epoch")]
    assert [l.split(":")[0] for l in epochs] == [
        f"Epoch {e:3d}" for e in range(5)]
    assert [l.split(":")[0] for l in epochs if "val_acc" in l] == [
        "Epoch   2", "Epoch   4"]
    assert "time per epoch:" in out
    acc = float(out.split("Test accuracy:", 1)[1].split()[0])
    ds = load_gnn_dataset(dataset)
    m = Model(make_config("gcn", 2, ds.feat_len, 16, ds.num_classes,
                          lr=0.02), ds, device="cpu")
    m.train(5, verbose=False)
    assert abs(acc - round(m.evaluate("test"), 4)) < 1e-6


def test_cli_tp_refusals(dataset):
    r = _cli("train", "ggnn", dataset, "1", "--device=cpu", GAB_SHARDS="4",
             GAB_TP="2")
    assert r.returncode == 2 and "ggnn" in r.stderr
    assert "Epoch" not in r.stdout
    if not torch.cuda.is_available():   # no fallback to the CPU
        r = _cli("train", "gcn", dataset, "1", GAB_SHARDS="4", GAB_TP="2")
        assert r.returncode != 0 and "Epoch" not in r.stdout
        assert "no CUDA device" in r.stderr
