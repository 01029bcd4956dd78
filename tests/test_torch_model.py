"""The port's loss, Adam, layer forwards and training Model (GCN, SAGE,
GAT, GGNN) against the JAX package's, on the same seeded numpy inputs."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu import native as jnative
from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.io import GnnDataset
from graphaibench_tpu.nn import layers as jl
from graphaibench_tpu.nn import losses as jlosses
from graphaibench_tpu.nn import model as jm
from graphaibench_tpu.nn import optim as joptim
from graphaibench_tpu_torch.nn import layers as tl
from graphaibench_tpu_torch.nn import losses as tlosses
from graphaibench_tpu_torch.nn import model as tm
from graphaibench_tpu_torch.nn import optim as toptim
from test_torch_sampler import jax_native  # noqa: F401  (a fixture)

torch.set_num_threads(2)


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


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
def test_masked_losses_and_grad_match_jax(kind):
    rng = np.random.default_rng(0)
    nv, ncls, begin, end = 50, 5, 5, 40
    logits = rng.standard_normal((nv, ncls)).astype(np.float32) * 3
    mask = (rng.random(nv) < 0.7).astype(np.uint8)
    if kind == "softmax":
        # labels reach ncls, as the reference reader's synthesized ones do
        labels = rng.integers(0, ncls + 1, nv).astype(np.int32)
        jfn, tfn = jlosses.masked_softmax_loss, tlosses.masked_softmax_loss
    else:
        labels = (rng.random((nv, ncls)) < 0.3).astype(np.uint8)
        jfn, tfn = jlosses.masked_sigmoid_loss, tlosses.masked_sigmoid_loss
    jout = jfn(jnp.asarray(logits), jnp.asarray(labels), begin, end,
               jnp.asarray(mask))
    jgrad = jax.grad(lambda z: jfn(z, jnp.asarray(labels), begin, end,
                                   jnp.asarray(mask))[0])(jnp.asarray(logits))
    tz = torch.from_numpy(logits).requires_grad_(True)
    tout = tfn(tz, torch.from_numpy(labels), begin, end, torch.from_numpy(mask))
    tout[0].backward()
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)


def test_adam_three_updates_match_jax():
    rng = np.random.default_rng(3)
    shapes = [(6, 4), (4, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jopt = joptim.Adam(lr=0.01)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    topt = toptim.Adam(tp, lr=0.01)
    for step in range(3):
        jp, jstate = jopt.update([jnp.asarray(g) for g in grads[step]],
                                 jstate, jp)
        for p, g in zip(tp, grads[step]):
            p.grad = torch.from_numpy(g)
        topt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl,head", [("ell", False), ("auto", False),
                                       ("ell", True)])
def test_apply_model_intermediates_match_jax(impl, head):
    """2-layer GCN on rmat10, F = 32, hidden 16, 4 classes; f32 sums in
    another order, rtol = atol = 1e-5."""
    g = rmat(10, 8, seed=0)
    x = np.random.default_rng(0).standard_normal((g.nv, 32)).astype(np.float32)
    jcfg = jl.make_config("gcn", 2, 32, 16, 4, spmm_impl=impl, use_l2norm=head)
    tcfg = tl.make_config("gcn", 2, 32, 16, 4, spmm_impl=impl, use_l2norm=head)
    jb = jm.GraphBundle.build(g, "gcn", spmm_impl=impl)
    jparams = jl.init_params(jcfg)
    jout, jacts = jl.apply_model(jcfg, jparams, jb.device, jb.edge_w_agg,
                                 jnp.asarray(x), return_intermediates=True)
    tb = tm.GraphBundle.build(g, "gcn", device="cpu", spmm_impl=impl)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.no_grad():
        tout, tacts = tl.apply_model(tcfg, tparams, tb.device, tb.edge_w_agg,
                                     torch.from_numpy(x),
                                     return_intermediates=True)
    assert len(tacts) == len(jacts) == (4 if head else 2)
    for t, j in zip(tacts + [tout], jacts + [jout]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale,impl", [(11, "ell"), (13, "auto")])
def test_model_trajectory_matches_jax(scale, impl):
    """5 training steps of the JAX Model and the port's on one dataset:
    reported loss, accuracy and final parameters. rmat13 has nv = 8192 >
    4096, so both sides take the packed ELL path. rtol 1e-4, atol 1e-5:
    f32 reductions in another order, compounded over 5 Adam steps."""
    g = rmat(scale, 8, seed=1)
    ds = _dataset(g, 32, 4)
    jcfg = jl.make_config("gcn", 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
    tcfg = tl.make_config("gcn", 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
    jmodel = jm.Model(jcfg, ds)
    tmodel = tm.Model(tcfg, ds, device="cpu")
    assert (jmodel.full.packed_w is not None) == (
        tmodel.full.packed_w is not None) == (scale == 13)
    jtraj = [jmodel.train_epoch() for _ in range(5)]
    ttraj = [tmodel.train_epoch() for _ in range(5)]
    np.testing.assert_allclose(ttraj, jtraj, rtol=1e-4, atol=1e-5)
    jparams = jax.tree.map(np.asarray, jmodel.params)
    tparams = dict(tmodel.params.named_parameters())
    for l, layer in enumerate(jparams["gconv"]):
        np.testing.assert_allclose(
            tparams[f"gconv.{l}.W_neigh"].detach().numpy(), layer["W_neigh"],
            rtol=1e-4, atol=1e-5)
    assert tmodel.evaluate("test") == pytest.approx(jmodel.evaluate("test"),
                                                   abs=1e-6)


def test_model_refuses_unported_routes():
    ds = _dataset(rmat(6, 4, seed=0), 8, 3)
    cfg = tl.make_config("gcn", 2, 8, 8, 3)
    with pytest.raises(ValueError, match="optimizer"):
        tm.Model(dataclasses.replace(cfg, optimizer="lbfgs"), ds, device="cpu")
    with pytest.raises(NotImplementedError, match="P11"):
        tm.Model(dataclasses.replace(cfg, remat=True), ds,
                 device="cpu").train_epoch()
    # the fused GAT attention on per-edge weights (v1) is what the
    # default ``trivial_w`` reaches on an ELL graph: equal to JAX's
    gat = tl.make_config("gat", 2, 8, 8, 3, spmm_impl="ell")
    m = tm.Model(gat, ds, device="cpu")
    with torch.no_grad():
        out = tl.apply_model(gat, m.params, m.full.device, m.full.edge_w_agg,
                             m.feats)
    jgat = jl.make_config("gat", 2, 8, 8, 3, spmm_impl="ell")
    jb = jm.GraphBundle.build(ds.graph, "gat", spmm_impl="ell")
    jout = jl.apply_model(jgat, jl.init_params(jgat), jb.device, jb.edge_w,
                          jnp.asarray(ds.feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)


def test_train_returns_one_entry_per_epoch():
    """``train`` and ``train_sampled`` return (loss, accuracy, seconds) per
    epoch where the JAX ``Model`` returns the total seconds: a stated
    difference. The seconds add up to what the JAX side would return."""
    ds = _dataset(rmat(8, 4, seed=0), 8, 3)
    cfg = tl.make_config("gcn", 2, 8, 8, 3, subg_size=64)
    model = tm.Model(cfg, ds, device="cpu", inductive=True)
    for log in (model.train(3, verbose=False),
                model.train_sampled(2, 64, verbose=False)):
        assert isinstance(log, list) and len(log) in (3, 2)
        for loss, acc, dt in log:
            assert np.isfinite(loss) and 0.0 <= acc <= 1.0 and dt > 0.0
    assert model.train(0, verbose=False) == []
    total = jm.Model(jl.make_config("gcn", 2, 8, 8, 3), ds).train(
        2, verbose=False)
    assert isinstance(total, float)


def test_model_seed_seeds_the_dropout_masks():
    """``Model(seed=)``, default 0: the default's trajectory is the one of
    an explicit 0 (and of the generator seeded with 0, as before the
    argument existed); another seed draws other masks."""
    ds = _dataset(rmat(8, 4, seed=0), 8, 3)
    cfg = dataclasses.replace(tl.make_config("gcn", 2, 8, 8, 3),
                              feat_drop=0.5)

    def run(**kw):
        model = tm.Model(cfg, ds, device="cpu", **kw)
        return [model.train_epoch() for _ in range(3)]

    default, zero, one = run(), run(seed=0), run(seed=1)
    assert default == zero
    assert default != one
    model = tm.Model(cfg, ds, device="cpu")
    model.generator = torch.Generator().manual_seed(0)
    assert [model.train_epoch() for _ in range(3)] == default


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_apply_model_ignores_remat_with_intermediates(arch):
    """``cfg.remat`` is refused on the plain forward, but with
    ``return_intermediates`` nothing can be rematerialized and the flag is
    ignored, as ``graphaibench_tpu/nn/layers.py::apply_model`` does."""
    g = rmat(8, 4, seed=0)
    x = np.random.default_rng(0).standard_normal((g.nv, 8)).astype(np.float32)
    cfg = tl.make_config(arch, 2, 8, 8, 3, spmm_impl="ell")
    jcfg = dataclasses.replace(jl.make_config(arch, 2, 8, 8, 3,
                                              spmm_impl="ell"), remat=True)
    tb = tm.GraphBundle.build(g, arch, device="cpu", spmm_impl="ell")
    jb = jm.GraphBundle.build(g, arch, spmm_impl="ell")
    jparams = jl.init_params(jcfg)
    params = tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.no_grad():
        want, want_acts = tl.apply_model(cfg, params, tb.device, tb.edge_w_agg,
                                         torch.from_numpy(x),
                                         return_intermediates=True)
        got, acts = tl.apply_model(dataclasses.replace(cfg, remat=True),
                                   params, tb.device, tb.edge_w_agg,
                                   torch.from_numpy(x),
                                   return_intermediates=True)
        with pytest.raises(NotImplementedError, match="P11"):
            tl.apply_model(dataclasses.replace(cfg, remat=True), params,
                           tb.device, tb.edge_w_agg, torch.from_numpy(x))
    assert torch.equal(got, want) and len(acts) == len(want_acts)
    jout, jacts = jl.apply_model(jcfg, jparams, jb.device, jb.edge_w_agg,
                                 jnp.asarray(x), return_intermediates=True)
    assert len(jacts) == len(acts)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)


ARCH_CASES = {
    # name: (arch, layers, dim_init, dim_hid, impl, config overrides)
    "sage_ell": ("sage", 2, 32, 16, "ell", {}),
    "sage_auto": ("sage", 2, 32, 16, "auto", {}),
    "sage_head": ("sage", 3, 12, 16, "ell", {"use_l2norm": True}),
    "gat_fused": ("gat", 2, 32, 16, "ell", {}),
    "gat_unfused_dense": ("gat", 2, 32, 16, "auto", {}),
    "gat_unfused_coo": ("gat", 2, 32, 16, "coo", {}),
    "gat_no_head": ("gat", 2, 32, 16, "ell", {"use_l2norm": False}),
    "ggnn_projected": ("ggnn", 1, 32, 16, "ell", {}),
    "ggnn_not_projected": ("ggnn", 1, 16, 16, "ell", {}),
    "ggnn_auto": ("ggnn", 1, 32, 16, "auto", {}),
}


def _both(name, g):
    arch, layers, din, dhid, impl, kw = ARCH_CASES[name]
    jcfg = jl.make_config(arch, layers, din, dhid, 4, spmm_impl=impl, **kw)
    tcfg = tl.make_config(arch, layers, din, dhid, 4, spmm_impl=impl, **kw)
    jb = jm.GraphBundle.build(g, arch, spmm_impl=impl)
    tb = tm.GraphBundle.build(g, arch, device="cpu", spmm_impl=impl)
    jparams = jl.init_params(jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jb, tb, jparams, tparams


@pytest.mark.parametrize("name", sorted(ARCH_CASES))
def test_arch_intermediates_match_jax(name):
    """Every layer's output and the head's at rmat10 (nv = 1024, so
    "auto" is the dense strategy and GAT's unfused path); f32 sums in
    another order, rtol = atol = 2e-5 (the fused GAT's own tolerance)."""
    g = rmat(10, 8, seed=0)
    jcfg, tcfg, jb, tb, jparams, tparams = _both(name, g)
    x = np.random.default_rng(0).standard_normal(
        (g.nv, tcfg.dim_init)).astype(np.float32)
    jout, jacts = jl.apply_model(jcfg, jparams, jb.device, jb.edge_w_agg,
                                 jnp.asarray(x), return_intermediates=True,
                                 trivial_w=True)
    with torch.no_grad():
        tout, tacts = tl.apply_model(tcfg, tparams, tb.device, tb.edge_w_agg,
                                     torch.from_numpy(x),
                                     return_intermediates=True,
                                     trivial_w=True)
    assert len(tacts) == len(jacts)
    for t, j in zip(tacts + [tout], jacts + [jout]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("impl", ["ell", "auto"])
def test_gat_layer_scores_match_jax(impl):
    """``return_scores`` takes the unfused path on any strategy: the
    layer's output and its per-edge softmax scores."""
    g = rmat(10, 8, seed=0)
    jcfg, tcfg, jb, tb, jparams, tparams = _both("gat_fused", g)
    jcfg = dataclasses.replace(jcfg, spmm_impl=impl)
    tcfg = dataclasses.replace(tcfg, spmm_impl=impl)
    x = np.random.default_rng(1).standard_normal((g.nv, 32)).astype(np.float32)
    jout, jscores = jl.gat_layer_fwd(
        jparams["gconv"][0], jb.device, jb.edge_w, jnp.asarray(x), act=True,
        cfg=jcfg, train=False, key=None, return_scores=True)
    with torch.no_grad():
        tout, tscores = tl.gat_layer_fwd(
            tparams.gconv[0], tb.device, tb.edge_w, torch.from_numpy(x),
            act=True, cfg=tcfg, train=False, generator=None,
            return_scores=True)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)


def test_ggnn_forward_matches_numpy_oracle():
    """The port's GGNN forward against an independent float64 numpy
    re-execution of the layer (projection, self-loop sum aggregation, GRU
    gates, l2norm + dense head), as tests/test_gnn.py holds the JAX one;
    rtol 1e-3, atol 1e-4 (float32 against float64)."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracle_gnn import spmm_np

    g = rmat(7, 4, seed=2)
    cfg = tl.make_config("ggnn", 2, 10, 16, 4)
    assert cfg.num_layers == 1 and cfg.use_dense
    feats = np.random.default_rng(0).standard_normal((g.nv, 10)).astype(np.float32)
    tb = tm.GraphBundle.build(g, "ggnn", device="cpu")
    params = tl.init_params(cfg, device="cpu")
    with torch.no_grad():
        out = tl.apply_model(cfg, params, tb.device, tb.edge_w,
                             torch.from_numpy(feats)).numpy()

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    p = {k: v.detach().numpy().astype(np.float64)
         for k, v in params.gconv[0].named_parameters()}
    hg = tb.host
    x = feats.astype(np.float64) @ p["W_neigh"]
    a = spmm_np(hg, np.ones(hg.ne), x)
    z = sig(a @ p["Wz"] + x @ p["Uz"])
    r = sig(a @ p["Wr"] + x @ p["Ur"])
    hc = np.tanh(a @ p["Wh"] + (r * x) @ p["Uh"])
    h = (1 - z) * x + z * hc
    h = h / np.sqrt(np.maximum((h * h).sum(1, keepdims=True), 1e-12))
    ref = h @ params.dense.W.detach().numpy().astype(np.float64)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("scale,impl", [(11, "ell"), (13, "auto")])
@pytest.mark.parametrize("arch", ["sage", "gat", "ggnn"])
def test_arch_trajectory_matches_jax(arch, scale, impl):
    """5 training steps of the JAX Model and the port's: reported loss,
    accuracy, every final parameter and the test accuracy. Both sides
    take the ELL strategy (GAT: the fused attention; rmat13 has nv = 8192
    > 4096). rtol 1e-4, atol 1e-5: f32 reductions in another order,
    compounded over 5 Adam steps."""
    g = rmat(scale, 8, seed=1)
    ds = _dataset(g, 32, 4)
    jcfg = jl.make_config(arch, 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
    tcfg = tl.make_config(arch, 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
    jmodel = jm.Model(jcfg, ds)
    tmodel = tm.Model(tcfg, ds, device="cpu")
    assert (jmodel.full.packed_w is not None) == (
        tmodel.full.packed_w is not None) == (scale == 13 and arch != "gat")
    jtraj = [jmodel.train_epoch() for _ in range(5)]
    ttraj = [tmodel.train_epoch() for _ in range(5)]
    np.testing.assert_allclose(ttraj, jtraj, rtol=1e-4, atol=1e-5)
    jparams = jax.tree.map(np.asarray, jmodel.params)
    tparams = dict(tmodel.params.named_parameters())
    n = 0
    for l, layer in enumerate(jparams["gconv"]):
        assert set(layer) == set(tl.LAYER_PARAMS[arch])
        for pname, value in layer.items():
            np.testing.assert_allclose(
                tparams[f"gconv.{l}.{pname}"].detach().numpy(), value,
                rtol=1e-4, atol=1e-5, err_msg=f"gconv.{l}.{pname}")
            n += 1
    if "dense" in jparams:
        np.testing.assert_allclose(tparams["dense.W"].detach().numpy(),
                                   jparams["dense"]["W"], rtol=1e-4, atol=1e-5)
        n += 1
    assert n == len(tparams)
    assert tmodel.evaluate("test") == pytest.approx(jmodel.evaluate("test"),
                                                   abs=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "nesterov",
                                       "adagrad", "rmsprop", "adamax"])
def test_model_takes_cfg_optimizer(optimizer):
    """GGNN without projection leaves W_neigh without a gradient: every
    rule must treat it as jax.grad's zero gradient does."""
    g = rmat(9, 8, seed=1)
    ds = _dataset(g, 16, 4)
    jcfg = jl.make_config("ggnn", 1, 16, 16, 4, lr=0.01, optimizer=optimizer)
    tcfg = tl.make_config("ggnn", 1, 16, 16, 4, lr=0.01, optimizer=optimizer)
    jmodel = jm.Model(jcfg, ds)
    tmodel = tm.Model(tcfg, ds, device="cpu")
    jtraj = [jmodel.train_epoch() for _ in range(3)]
    ttraj = [tmodel.train_epoch() for _ in range(3)]
    np.testing.assert_allclose(ttraj, jtraj, rtol=1e-4, atol=1e-5)
    assert tmodel.params.gconv[0].W_neigh.grad is None
    np.testing.assert_allclose(
        tmodel.params.gconv[0].W_neigh.detach().numpy(),
        np.asarray(jmodel.params["gconv"][0]["W_neigh"]), rtol=1e-6)


@pytest.mark.parametrize("impl", ["ell", "auto"])
def test_gat_gradient_is_the_full_gradient(impl):
    """The port's GAT gradient, fused (ell) and unfused (auto: dense at
    this size), is the full gradient of autodiff, as the JAX package's:
    it follows the float64 oracle with the feature -> score path
    (``full_grad=True``) and leaves the reference binary's partial
    gradient (tests/test_reference_parity.py::test_gat_parity_gap_explained)."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracle_gnn import GatOracle

    g = rmat(8, 6, seed=5)
    ds = _dataset(g, 12, 4)
    cfg = tl.make_config("gat", 2, 12, 8, 4, lr=0.02, spmm_impl=impl)
    model = tm.Model(cfg, ds, device="cpu")
    init = {"gconv": [{k: v.detach().numpy() for k, v in
                       layer.named_parameters()}
                      for layer in model.params.gconv],
            "dense": {"W": model.params.dense.W.detach().numpy()}}
    b, e, _ = ds.train_range
    oracles = {full: GatOracle(model.full.host, cfg.gconv_dims, init, cfg.lr,
                               b, e, ds.labels, ds.train_mask, full_grad=full,
                               ref_adam_schedule=False)
               for full in (True, False)}
    ours = [model.train_epoch()[0] for _ in range(6)]
    exact = [oracles[True].step(ds.feats)[0] for _ in range(6)]
    partial = [oracles[False].step(ds.feats)[0] for _ in range(6)]
    np.testing.assert_allclose(ours, exact, atol=2e-4)
    assert max(abs(a - b) for a, b in zip(exact, partial)) > 1e-3
    np.testing.assert_allclose(
        model.params.gconv[0].W_neigh.detach().numpy(), oracles[True].W[0],
        atol=2e-4)


def _jax_sampled_log(monkeypatch, jmodel, epochs, subg_size, seed):
    """(loss, acc) per epoch of the JAX Model's ``train_sampled`` at full
    precision: its jitted step is wrapped where ``train_sampled`` makes
    it, since the method itself only prints three decimals."""
    log = []
    real_jit = jax.jit

    def spy(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") != "sampled_step":
            return jitted

        def run(*args):
            out = jitted(*args)
            log.append((float(out[2]), float(out[3])))
            return out
        return run

    monkeypatch.setattr(jax, "jit", spy)
    jmodel.train_sampled(epochs, subg_size, verbose=False, seed=seed)
    monkeypatch.setattr(jax, "jit", real_jit)
    assert len(log) == epochs
    return log


def _assert_params_match(tmodel, jmodel, arch):
    jparams = jax.tree.map(np.asarray, jmodel.params)
    tparams = dict(tmodel.params.named_parameters())
    want = {f"gconv.{l}.{k}": v for l, layer in enumerate(jparams["gconv"])
            for k, v in layer.items()}
    if "dense" in jparams:
        want["dense.W"] = jparams["dense"]["W"]
    assert set(want) == set(tparams)
    for name, value in want.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), value,
                                   rtol=1e-4, atol=1e-5, err_msg=name)


SAMPLED_CASES = {
    # name: (scale, subg_size, config overrides); n_pad <= 4096 takes the
    # dense strategy, above it COO
    "dense": (11, 600, {}),
    "coo": (13, 5000, {}),
}


@pytest.mark.parametrize("case", sorted(SAMPLED_CASES))
@pytest.mark.parametrize("arch", ["gcn", "sage", "gat", "ggnn"])
def test_sampled_trajectory_matches_jax(arch, case, monkeypatch, jax_native):
    """3 epochs of ``train_sampled`` of the JAX Model and the port's on
    one dataset, the same sampler seeds: loss and accuracy per epoch, every
    final parameter and the test accuracy. rtol 1e-4, atol 1e-5: f32
    reductions in another order, compounded over 3 Adam steps. Both
    samplers take their C++ route (``jax_native``)."""
    _sampled_case(arch, case, monkeypatch)


def test_sampled_trajectory_survives_a_lost_native_build(monkeypatch,
                                                        request):
    """A test process in which the JAX package's native library did not
    load (here: switched off by ``GAB_DISABLE_NATIVE``, as a process that
    lost the race of the first-use build is left) still compares like
    with like: the ``jax_native`` fixture loads the library again."""
    monkeypatch.setenv("GAB_DISABLE_NATIVE", "1")
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    assert not jnative.available()
    request.getfixturevalue("jax_native")
    assert jnative.available()
    _sampled_case("gcn", "dense", monkeypatch)


def _sampled_case(arch, case, monkeypatch):
    scale, subg, kw = SAMPLED_CASES[case]
    ds = _dataset(rmat(scale, 8, seed=1), 32, 4)
    args = (arch, 2, 32, 16, 4)
    jmodel = jm.Model(jl.make_config(*args, lr=0.01, subg_size=subg, **kw), ds,
                      inductive=True)
    tmodel = tm.Model(tl.make_config(*args, lr=0.01, subg_size=subg, **kw), ds,
                      device="cpu", inductive=True)
    assert tmodel.cfg.use_dense
    jlog = _jax_sampled_log(monkeypatch, jmodel, 3, subg, seed=5)
    tlog = tmodel.train_sampled(3, subg, verbose=False, seed=5)
    np.testing.assert_allclose([(l, a) for l, a, _ in tlog], jlog,
                               rtol=1e-4, atol=1e-5)
    _assert_params_match(tmodel, jmodel, arch)
    assert tmodel.evaluate("test") == pytest.approx(jmodel.evaluate("test"),
                                                   abs=1e-6)


def test_sampled_step_applies_no_dropout(monkeypatch, capsys, jax_native):
    """With feat_drop 0.5 the sampled step of either package drops
    nothing (it hands the forward no key / no generator), so the
    trajectories stay equal; and the verbose lines carry ``subg_nv``."""
    ds = _dataset(rmat(11, 8, seed=1), 32, 4)
    kw = dict(lr=0.01, subg_size=600, feat_drop=0.5, score_drop=0.3)
    jmodel = jm.Model(jl.make_config("gat", 2, 32, 16, 4, **kw), ds,
                      inductive=True)
    tmodel = tm.Model(tl.make_config("gat", 2, 32, 16, 4, **kw), ds,
                      device="cpu", inductive=True)
    jlog = _jax_sampled_log(monkeypatch, jmodel, 3, 600, seed=0)
    tlog = tmodel.train_sampled(3, 600, val_interval=2, seed=0)
    np.testing.assert_allclose([(l, a) for l, a, _ in tlog], jlog,
                               rtol=1e-4, atol=1e-5)
    _assert_params_match(tmodel, jmodel, "gat")
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("Epoch")]
    assert len(lines) == 3 and all(" subg_nv " in l for l in lines)
    assert "val_acc" in lines[2] and "val_acc" not in lines[1]


def test_sampled_graph_has_no_buckets():
    """The padded subgraph is COO-only: it builds without ELL buckets and
    picks the dense strategy up to 4096 vertices, COO above."""
    from graphaibench_tpu_torch.ops.device_graph import coo_device_graph
    from graphaibench_tpu_torch.ops.spmm import _pick_impl

    z = np.zeros(8, np.int32)
    for nv, want in ((4096, "dense"), (4104, "coo")):
        dg = coo_device_graph(z, z, np.arange(8, dtype=np.int32),
                              np.zeros(nv, np.int32), nv=nv, device="cpu")
        assert not dg.has_ell_layout and dg.ne == 8
        assert _pick_impl(dg, "auto") == want


@pytest.mark.parametrize("arch", ["gcn", "gat", "sage"])
def test_inductive_trajectory_matches_jax(arch):
    """5 full-batch steps on the subgraph of the train-masked vertices
    (both drop rates 0: the two packages draw dropout from other
    streams), evaluation on the full graph. rmat13, so the ELL strategy;
    rtol 1e-4, atol 1e-5 as the other trajectories."""
    g = rmat(13, 8, seed=1)
    ds = _dataset(g, 32, 4)
    ds.train_mask = (np.arange(g.nv) % 3 != 0).astype(np.uint8)
    jmodel = jm.Model(jl.make_config(arch, 2, 32, 16, 4, lr=0.01), ds,
                      inductive=True)
    tmodel = tm.Model(tl.make_config(arch, 2, 32, 16, 4, lr=0.01), ds,
                      device="cpu", inductive=True)
    assert tmodel.training is not tmodel.full
    assert tmodel.training.host.ne == jmodel.training.host.ne < tmodel.full.host.ne
    jtraj = [jmodel.train_epoch() for _ in range(5)]
    ttraj = [tmodel.train_epoch() for _ in range(5)]
    np.testing.assert_allclose(ttraj, jtraj, rtol=1e-4, atol=1e-5)
    _assert_params_match(tmodel, jmodel, arch)
    assert tmodel.evaluate("test") == pytest.approx(jmodel.evaluate("test"),
                                                   abs=1e-6)


def _toy():
    """tests/test_gnn.py::make_toy, with the port's generator."""
    from graphaibench_tpu_torch.graph.generators import uniform_random

    nv = 60
    g = uniform_random(nv, 150, seed=5)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((nv, 10)).astype(np.float32)
    labels = rng.integers(0, 4, nv).astype(np.int32)
    mask = np.zeros(nv, dtype=np.uint8)
    mask[: nv // 2] = 1
    return g, feats, labels, mask


def test_gcn_forward_parity_with_oracle():
    """Per-layer activations of the port's GCN against the float64
    reference-semantics oracle, as tests/test_gnn.py holds the JAX one:
    rtol 1e-4, atol 1e-5."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracle_gnn import GcnOracle

    g, feats, labels, mask = _toy()
    cfg = tl.ModelConfig(arch="gcn", num_layers=2, dim_init=10, dim_hid=16,
                         num_cls=4, lr=0.02)
    gb = tm.GraphBundle.build(g, "gcn", device="cpu")
    params = tl.init_params(cfg, device="cpu")
    with torch.no_grad():
        _, acts = tl.apply_model(cfg, params, gb.device, gb.edge_w,
                                 torch.from_numpy(feats),
                                 return_intermediates=True)
    oracle = GcnOracle(gb.host, gb.edge_w.numpy(), cfg.gconv_dims,
                       [p.W_neigh.detach().numpy() for p in params.gconv],
                       cfg.lr, 0, 30, labels, mask)
    for a, r in zip(acts, oracle.forward(feats)):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-5)


def test_gcn_training_parity_three_steps():
    """Losses and weights of 3 full steps (forward, backward, Adam)
    against the oracle: |loss diff| < 1e-4, weights rtol 1e-3 / atol 1e-5,
    the tolerances of tests/test_gnn.py."""
    sys.path.insert(0, os.path.dirname(__file__))
    from oracle_gnn import GcnOracle

    g, feats, labels, mask = _toy()
    begin, end = 0, 30
    cfg = tl.ModelConfig(arch="gcn", num_layers=2, dim_init=10, dim_hid=16,
                         num_cls=4, lr=0.02)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=4,
                    train_range=(begin, end, int(mask[begin:end].sum())),
                    val_range=(begin, end, 1), test_range=(begin, end, 1))
    model = tm.Model(cfg, ds, device="cpu")
    oracle = GcnOracle(model.full.host, model.full.edge_w.numpy(),
                       cfg.gconv_dims,
                       [p.W_neigh.detach().numpy().copy()
                        for p in model.params.gconv],
                       cfg.lr, begin, end, labels, mask)
    for step in range(3):
        loss, _ = model.train_epoch()
        ref_loss, _ = oracle.step(feats)
        assert abs(loss - ref_loss) < 1e-4, (step, loss, ref_loss)
    for l in range(2):
        np.testing.assert_allclose(
            model.params.gconv[l].W_neigh.detach().numpy(), oracle.W[l],
            rtol=1e-3, atol=1e-5)


def test_model_timers_collect_the_stages():
    from graphaibench_tpu_torch.utils import timers as tt

    ds = _dataset(rmat(9, 8, seed=1), 16, 4)
    timers = tt.OpTimers()
    model = tm.Model(tl.make_config("gcn", 2, 16, 16, 4, subg_size=100), ds,
                     device="cpu", inductive=True, timers=timers)
    model.train(2, verbose=False)
    model.train_sampled(3, 100, verbose=False)
    model.evaluate("val")
    assert dict(timers.counts) == {tt.OP_STEP: 5, tt.OP_SAMPLE: 3,
                                   tt.OP_EVAL: 1}
    assert all(t > 0 for t in timers.times.values())


MATH_CASES = {
    "leaky_relu": lambda m, a, b: m.leaky_relu(a, 0.2),
    "cross_entropy": lambda m, a, b: m.cross_entropy(
        b, a * a / (a * a).sum(-1, keepdims=True)),
    "l2norm_rows": lambda m, a, b: m.l2norm_rows(a),
    "accuracy": lambda m, a, b: m.masked_accuracy_single(a, b.argmax(-1), b[:, 0] >= 0),
    "f1_micro": lambda m, a, b: m.masked_f1_micro(abs(a) / 3, b, b[:, 1] >= 0),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_ops_match_jax(name):
    from graphaibench_tpu.ops import math as jmath
    from graphaibench_tpu_torch.ops import math as tmath

    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, 6)).astype(np.float32)
    a[0] = 0.0   # a zero row: the l2norm clamp and a zero probability
    b = (rng.random((40, 6)) < 0.4).astype(np.float32)
    j = MATH_CASES[name](jmath, jnp.asarray(a), jnp.asarray(b))
    t = MATH_CASES[name](tmath, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_dropout_keeps_and_scales():
    from graphaibench_tpu_torch.ops import math as tmath

    x = torch.ones(200, 50)
    out, keep = tmath.dropout(torch.Generator().manual_seed(0), x, 0.25)
    assert abs(keep.float().mean().item() - 0.75) < 0.02
    assert torch.equal(out[keep], torch.full_like(out[keep], 1 / 0.75))
    assert torch.equal(out[~keep], torch.zeros_like(out[~keep]))
