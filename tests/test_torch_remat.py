"""Layer remat of the port (``cfg.remat``: ``nn/layers.py::_remat_layer``,
each gconv layer under ``torch.utils.checkpoint``) held against the port
without remat and against the JAX package's ``jax.checkpoint`` of the layer.

With dropout the masks come from ``Model.generator``: a layer recomputed in
the backward must draw the forward's masks, so the loss and every gradient
with remat equal those without (within 1e-6; the same float operations in
the same order give them bit for bit) at ``feat_drop`` 0.5 and GAT's
``score_drop`` 0.3, and so do 3-epoch ``Model`` trajectories. At rate 0 the
remat forward and its gradients equal JAX's remat forward within 1e-5
(float32 sums in another order). The launches of the kernels' plain
versions a step, counted on the CPU, hold what ``chip_smoke.py``'s remat
phase asserts on the card: a remat step runs a layer's forward SpMM or GAT
v2 passes again where the backward needs a tensor saved after them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.generators import rmat as jrmat
from graphaibench_tpu.nn import layers as jl
from graphaibench_tpu.nn import losses as jlosses
from graphaibench_tpu.nn import model as jm
from graphaibench_tpu_torch import GnnDataset
from graphaibench_tpu_torch.graph.generators import rmat
from graphaibench_tpu_torch.nn import layers as tl
from graphaibench_tpu_torch.nn import losses as tlosses
from graphaibench_tpu_torch.nn import model as tm
from graphaibench_tpu_torch.ops import ell_spmm as K1
from graphaibench_tpu_torch.ops import fused_gat as FG
from test_torch_sampler import jax_native  # noqa: F401  (a fixture)

torch.set_num_threads(2)

GRAD_ATOL = 1e-6
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = {"gcn": 2, "sage": 3, "gat": 2, "ggnn": 1}


def _dataset(g, feat, classes, seed=0):
    rng = np.random.default_rng(seed)
    nv, half = g.nv, g.nv // 2
    ones = np.ones(nv, dtype=np.uint8)
    return GnnDataset(
        graph=g, feats=rng.standard_normal((nv, feat)).astype(np.float32),
        labels=rng.integers(0, classes, nv).astype(np.int32),
        train_mask=ones, val_mask=ones, test_mask=ones, num_classes=classes,
        train_range=(0, half, half), val_range=(half, nv, nv - half),
        test_range=(half, nv, nv - half))


def _loss_and_grads(cfg, model, trivial_w):
    """One forward with dropout from a fresh generator and the backward:
    (loss, {name: grad})."""
    model.params.zero_grad()
    gen = torch.Generator().manual_seed(5)
    b = model.training
    logits = tl.apply_model(cfg, model.params, b.device, b.edge_w_agg,
                            model.feats, train=True, generator=gen,
                            trivial_w=trivial_w)
    begin, end, _ = model.ranges["train"]
    lg, rep, _ = tlosses.masked_softmax_loss(logits, model.labels, begin, end,
                                             model.masks["train"])
    lg.backward()
    return float(rep.detach()), {
        n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
        for n, p in model.params.named_parameters()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("impl,trivial_w", [("ell", True), ("ell", False),
                                            ("coo", True)])
def test_remat_gradients_equal_plain_under_dropout(arch, impl, trivial_w):
    """feat_drop 0.5, GAT's score_drop 0.3 (its unfused path); the fused
    GAT paths (v2 with ``trivial_w``, v1 without) at feat_drop only."""
    ds = _dataset(rmat(9, 6, seed=1), 12, 4)
    kw = dict(feat_drop=0.5, spmm_impl=impl)
    runs = {}
    for score_drop in ((0.3, 0.0) if arch == "gat" else (0.0,)):
        for remat in (False, True):
            cfg = tl.make_config(arch, ARCHS[arch], 12, 8, 4, remat=remat,
                                 score_drop=score_drop, **kw)
            model = tm.Model(cfg, ds, device="cpu")
            runs[score_drop, remat] = _loss_and_grads(cfg, model, trivial_w)
        (l0, g0), (l1, g1) = runs[score_drop, False], runs[score_drop, True]
        assert l1 == pytest.approx(l0, abs=GRAD_ATOL)
        assert g0.keys() == g1.keys()
        for name in g0:
            torch.testing.assert_close(g1[name], g0[name], rtol=0,
                                       atol=GRAD_ATOL, msg=name)
        assert any(float(g.abs().max()) > 0 for g in g0.values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_trajectory_with_remat_equals_without(arch):
    """3 epochs of Model at feat_drop 0.5 (GAT also score_drop 0.3): the
    same losses, accuracies and weights, and the generator left where a run
    without remat leaves it."""
    ds = _dataset(rmat(9, 6, seed=2), 12, 4)
    out = {}
    for remat in (False, True):
        cfg = tl.make_config(arch, ARCHS[arch], 12, 8, 4, feat_drop=0.5,
                             score_drop=0.3 if arch == "gat" else 0.0,
                             remat=remat)
        model = tm.Model(cfg, ds, device="cpu", seed=9)
        traj = [model.train_epoch() for _ in range(3)]
        out[remat] = (traj, dict(model.params.named_parameters()),
                      model.generator.get_state())
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=0,
                               atol=GRAD_ATOL)
    for name, p in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], p, rtol=0,
                                   atol=GRAD_ATOL, msg=name)
    assert torch.equal(out[True][2], out[False][2])


def test_remat_is_ignored_without_autograd_and_with_intermediates():
    """Under no_grad (evaluation) and with ``return_intermediates`` the
    layers run as they are; the outputs equal remat's off."""
    ds = _dataset(rmat(8, 4, seed=0), 8, 3)
    cfg = tl.make_config("gcn", 2, 8, 8, 3, remat=True)
    model = tm.Model(cfg, ds, device="cpu")
    plain = dataclasses.replace(cfg, remat=False)
    b = model.full
    with torch.no_grad():
        a = tl.apply_model(cfg, model.params, b.device, b.edge_w_agg,
                           model.feats)
        c = tl.apply_model(plain, model.params, b.device, b.edge_w_agg,
                           model.feats)
    assert torch.equal(a, c)
    out, acts = tl.apply_model(cfg, model.params, b.device, b.edge_w_agg,
                               model.feats, return_intermediates=True)
    assert len(acts) == 2 and acts[-1] is out
    assert model.evaluate("test") == tm.Model(plain, ds,
                                              device="cpu").evaluate("test")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_forward_and_gradients_equal_jax_remat(arch, jax_native):
    """At rate 0: the port's remat forward (train=True, a generator) and
    its parameter gradients against JAX's ``cfg.remat`` forward (a key) and
    ``jax.grad``, on the ELL strategy (``trivial_w``: GAT's fused v2)."""
    g = jrmat(13, 4, seed=0)             # > 4096 vertices: the ELL strategy
    ds = _dataset(g, 16, 5)
    dims = (ARCHS[arch], 16, 8, 5)
    jcfg = jl.make_config(arch, *dims, remat=True, spmm_impl="ell")
    tcfg = tl.make_config(arch, *dims, remat=True, spmm_impl="ell")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jb = jm.GraphBundle.build(g, arch, spmm_impl="ell")
    jparams = jl.init_params(jcfg)
    feats = jnp.asarray(ds.feats)
    labels = jnp.asarray(ds.labels)
    mask = jnp.asarray(ds.train_mask)
    begin, end, _ = ds.train_range

    def jloss(params):
        logits = jl.apply_model(jcfg, params, jb.device, jb.edge_w_agg,
                                feats, train=True, key=jax.random.PRNGKey(0),
                                trivial_w=True)
        return jlosses.masked_softmax_loss(logits, labels, begin, end,
                                           mask)[0], logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    model = tm.Model(tcfg, ds, device="cpu")
    model.params.zero_grad()
    logits = tl.apply_model(tcfg, model.params, model.full.device,
                            model.full.edge_w_agg, model.feats, train=True,
                            generator=model.generator, trivial_w=True)
    tlosses.masked_softmax_loss(logits, model.labels, begin, end,
                                model.masks["train"])[0].backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **JAX_TOL)
    tg = dict(model.params.named_parameters())
    for l, layer in enumerate(jgrads["gconv"]):
        for name, gj in layer.items():
            np.testing.assert_allclose(tg[f"gconv.{l}.{name}"].grad.numpy(),
                                       np.asarray(gj), **JAX_TOL,
                                       err_msg=f"gconv.{l}.{name}")
    if "dense" in jgrads:
        np.testing.assert_allclose(tg["dense.W"].grad.numpy(),
                                   np.asarray(jgrads["dense"]["W"]),
                                   **JAX_TOL)


@pytest.mark.parametrize("arch", ["gcn", "sage", "gat", "ggnn"])
def test_remat_step_launches(arch, monkeypatch):
    """Per step, by kernel, without remat and with it, on chip_smoke.py's
    remat models (``remat_configs``) at rmat13 with the ELL strategy: the
    calls of the kernels' plain versions equal the launches that the remat
    phase holds the card to (``REMAT_STEP_LAUNCHES``)."""
    import chip_smoke

    calls = {}

    def counted(mod, name, kernel):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[kernel] = calls.get(kernel, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counted(K1, "ell_spmm_plain", "ell_spmm")
    for kernel in ("gat_rowmax", "gat_v2_fwd", "gat_v2_bwd_sl",
                   "gat_v2_bwd_h", "gat_v2_bwd"):
        counted(FG, f"{kernel}_plain", kernel)
    # the GAT backward as one pass or two as the card's rule picks it at
    # rmat17: one at F = 128, two at F = 16
    monkeypatch.setattr(FG, "_single_pass",
                        lambda nv, f: f == chip_smoke.HIDDEN)
    cfg = chip_smoke.remat_configs()[arch]
    ds = _dataset(rmat(13, 4, seed=0), cfg.dim_init, cfg.num_cls)
    got = []
    for remat in (False, True):
        model = tm.Model(dataclasses.replace(cfg, remat=remat,
                                             spmm_impl="ell"),
                         ds, device="cpu")
        model.train_epoch()
        calls.clear()
        model.train_epoch()
        got.append(dict(calls))
    assert tuple(got) == chip_smoke.REMAT_STEP_LAUNCHES[arch]
