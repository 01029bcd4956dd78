"""The port's loss, Adam, GCN forward and training Model against the JAX
package's, on the same seeded numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    with pytest.raises(NotImplementedError, match="P4"):
        tm.Model(dataclasses.replace(cfg, optimizer="sgd"), ds, device="cpu")
    with pytest.raises(NotImplementedError, match="P11"):
        tm.Model(dataclasses.replace(cfg, remat=True), ds,
                 device="cpu").train_epoch()


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
