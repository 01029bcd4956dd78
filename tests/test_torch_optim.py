"""The port's optimizers against the JAX package's: three updates of each
rule on the same parameters and gradients, a zero gradient with weight
decay, and a parameter autograd gave no gradient. Tolerance rtol 1e-6,
atol 1e-7: the same float32 arithmetic, fused differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.nn import optim as joptim
from graphaibench_tpu_torch.nn import optim as toptim

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = [(6, 4), (4, 3), (5,)]

CASES = {
    "sgd": {},
    "sgd_decay": {"weight_decay": 0.1},
    "momentum": {},
    "momentum_decay": {"weight_decay": 0.05},
    "nesterov": {},
    "nesterov_decay": {"weight_decay": 0.05},
    "adagrad": {},
    "rmsprop": {},
    "adamax": {},
    "adam": {},
}


def _run(name, kw, grads_per_step, params):
    """Both packages through the given gradients (``None`` entries mean
    'no gradient' for the port and zeros for jax.grad's convention)."""
    rule = name.split("_")[0]
    jopt = joptim.OPTIMIZERS[rule](lr=0.01, **kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    topt = toptim.OPTIMIZERS[rule](tp, lr=0.01, **kw)
    for grads in grads_per_step:
        jgrads = [jnp.zeros_like(p) if g is None else jnp.asarray(g)
                  for p, g in zip(jp, grads)]
        jp, jstate = jopt.update(jgrads, jstate, jp)
        topt.zero_grad()
        for p, g in zip(tp, grads):
            p.grad = None if g is None else torch.from_numpy(g)
        topt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       **TOL)
    return tp


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_updates_match_jax(name):
    params, grads = _inputs()
    _run(name, CASES[name], grads, params)


@pytest.mark.parametrize("name", sorted(CASES))
def test_zero_and_missing_gradients_match_jax(name):
    """Step 2 has a zero gradient for parameter 0 and no gradient at all
    for parameter 1: with weight decay or momentum the weights still
    move, as with ``jax.grad``'s zeros."""
    params, grads = _inputs(seed=4)
    grads[1][0] = np.zeros_like(grads[1][0])
    grads[1][1] = None
    grads[2][1] = None
    before = [p.copy() for p in params]
    tp = _run(name, CASES[name], grads, params)
    if CASES[name].get("weight_decay") or name.startswith(("momentum",
                                                           "nesterov")):
        assert not np.allclose(tp[1].detach().numpy(), before[1])


def test_optimizers_dict_names_match():
    assert sorted(toptim.OPTIMIZERS) == sorted(joptim.OPTIMIZERS)
    for name, cls in toptim.OPTIMIZERS.items():
        jdefaults = joptim.OPTIMIZERS[name]()
        ours = cls([torch.zeros(1)])
        for field in ("lr", "mu", "b1", "b2", "eps", "weight_decay"):
            if hasattr(jdefaults, field):
                assert getattr(ours, field) == getattr(jdefaults, field), (
                    name, field)
