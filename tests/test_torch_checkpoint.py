"""Save/restore of the port's Model, optimizer state carried over from the
JAX package, and the port's entry point against the JAX package's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.nn import layers as jl
from graphaibench_tpu.nn import model as jm
from graphaibench_tpu_torch import entry as tentry
from graphaibench_tpu_torch.nn import layers as tl
from graphaibench_tpu_torch.nn import model as tm
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS, opt_state_from_jax
from graphaibench_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from test_torch_model import _dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(model):
    return ([p.detach().clone() for p in model.params.parameters()],
            {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
             for k, v in model.opt.state_dict().items()})


@pytest.mark.parametrize("arch,optimizer", [("gcn", "adam"), ("gat", "adam"),
                                            ("sage", "momentum"),
                                            ("ggnn", "adamax"),
                                            ("gcn", "sgd")])
def test_save_restore_resumes_bit_equal(tmp_path, arch, optimizer):
    """2 steps, save, a fresh Model, restore, 2 more steps: bit-equal on
    the CPU to 4 uninterrupted steps (losses, parameters, optimizer
    state), for state shapes (m, v, b1_t, b2_t), (dw_prev,), (m, u, b1_t)
    and none."""
    ds = _dataset(rmat(9, 8, seed=1), 16, 4)
    cfg = tl.make_config(arch, 2, 16, 16, 4, lr=0.01, optimizer=optimizer)
    whole = tm.Model(cfg, ds, device="cpu")
    want = [whole.train_epoch() for _ in range(4)]
    first = tm.Model(cfg, ds, device="cpu")
    got = [first.train_epoch() for _ in range(2)]
    path = first.save(str(tmp_path / "ckpt"), step=2)
    assert path.endswith("step_2.pt") and os.path.isfile(path)
    second = tm.Model(cfg, ds, device="cpu")
    second.restore(str(tmp_path / "ckpt"), step=2)
    got += [second.train_epoch() for _ in range(2)]
    assert got == want
    (wp, ws), (gp, gs) = _state(whole), _state(second)
    assert all(torch.equal(a, b) for a, b in zip(wp, gp))
    assert sorted(ws) == sorted(gs) == sorted(
        OPTIMIZERS[optimizer].BUFFERS + OPTIMIZERS[optimizer].SCALARS)
    for k in ws:
        for a, b in zip(ws[k] if isinstance(ws[k], list) else [ws[k]],
                        gs[k] if isinstance(gs[k], list) else [gs[k]]):
            assert torch.equal(a, b), k


def test_restore_rejects_another_models_checkpoint(tmp_path):
    ds = _dataset(rmat(8, 8, seed=1), 16, 4)
    small = tm.Model(tl.make_config("gcn", 2, 16, 8, 4), ds, device="cpu")
    small.save(str(tmp_path))
    other = tm.Model(tl.make_config("gcn", 2, 16, 16, 4), ds, device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        other.restore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        other.restore(str(tmp_path), step=7)


def test_checkpoint_holds_plain_tensors_only(tmp_path):
    """The file loads with ``weights_only=True`` and an object that is not
    a tensor or a plain container does not."""
    save_checkpoint(str(tmp_path), {"a": [torch.arange(3)], "b": torch.ones(())})
    back = restore_checkpoint(str(tmp_path))
    assert torch.equal(back["a"][0], torch.arange(3)) and back["b"] == 1
    save_checkpoint(str(tmp_path), {"fn": OPTIMIZERS["adam"]}, step=1)
    with pytest.raises(Exception, match="[Ww]eights"):
        restore_checkpoint(str(tmp_path), step=1)


@pytest.mark.parametrize("arch,optimizer", [
    ("gcn", "adam"), ("gat", "adamax"), ("ggnn", "momentum"),
    ("sage", "nesterov"), ("gcn", "adagrad"), ("gat", "rmsprop"),
    ("sage", "sgd")])
def test_opt_state_from_jax_continues_the_jax_run(arch, optimizer):
    """Both packages start from the JAX Model's state after 2 steps
    (parameters through ``params_from_jax``, optimizer state through
    ``opt_state_from_jax``) and take 2 more: the same losses and
    parameters, rtol 1e-4 / atol 1e-5 (f32 reductions in another order);
    and the state carried over equals the JAX arrays bit for bit."""
    ds = _dataset(rmat(9, 8, seed=1), 16, 4)
    kw = dict(lr=0.01, optimizer=optimizer)
    jmodel = jm.Model(jl.make_config(arch, 2, 16, 16, 4, **kw), ds)
    for _ in range(2):
        jmodel.train_epoch()
    tmodel = tm.Model(tl.make_config(arch, 2, 16, 16, 4, **kw), ds,
                      device="cpu")
    jparams = jax.tree.map(np.asarray, jmodel.params)
    jstate = jax.tree.map(np.asarray, jmodel.opt_state)
    with torch.no_grad():
        carried = tl.params_from_jax(jparams, "cpu")
        for p, q in zip(tmodel.params.parameters(), carried.parameters()):
            p.copy_(q)
    opt_state_from_jax(tmodel.opt, jstate)
    state = tmodel.opt.state_dict()
    for name in tmodel.opt.BUFFERS:
        for t, j in zip(state[name],
                        tl.leaves_in_param_order(getattr(jstate, name))):
            np.testing.assert_array_equal(t.numpy(), j, err_msg=name)
    for name in tmodel.opt.SCALARS:
        assert float(state[name]) == float(getattr(jstate, name)), name
    jtraj = [jmodel.train_epoch() for _ in range(2)]
    ttraj = [tmodel.train_epoch() for _ in range(2)]
    np.testing.assert_allclose(ttraj, jtraj, rtol=1e-4, atol=1e-5)
    for t, j in zip(tmodel.params.parameters(), tl.leaves_in_param_order(
            jax.tree.map(np.asarray, jmodel.params))):
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4, atol=1e-5)


def test_leaves_follow_the_ports_parameter_order():
    """Whatever order a dict has the names in (jax.tree.map sorts them)."""
    layer = {k: np.full(1, i, np.float32) for i, k in enumerate(
        ["Uh", "Ur", "Uz", "W_neigh", "Wh", "Wr", "Wz"])}
    tree = {"dense": {"W": np.full(1, 9, np.float32)}, "gconv": [layer]}
    got = [float(a[0]) for a in tl.leaves_in_param_order(tree)]
    assert got == [3, 6, 2, 5, 1, 4, 0, 9]
    names = [n for n, _ in tl.params_from_jax(tree, "cpu").named_parameters()]
    assert names == [f"gconv.0.{k}" for k in tl.LAYER_PARAMS["ggnn"]] + ["dense.W"]


def test_entry_matches_the_jax_entry():
    """``entry()`` on the CPU against ``__graft_entry__.entry()``: the same
    toy set-up, logits rtol = atol = 1e-5."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as jentry

    jfn, (jparams, jx) = jentry.entry()
    tfn, (tparams, tx) = tentry.entry(device="cpu")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    with torch.no_grad():
        tout = tfn(tparams, tx)
    jout = jax.jit(jfn)(jparams, jnp.asarray(jx))
    assert tuple(tout.shape) == jout.shape == (1024, 8)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)


def test_entry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError)):
        tentry.entry()
