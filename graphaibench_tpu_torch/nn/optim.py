"""The reference's optimizers, written out by hand.

Counterpart of ``graphaibench_tpu/nn/optim.py`` (the update rules of the
reference's optimizer.h:23-193). The reference's Adam keeps running decay
powers that START at b1/b2 (optimizer.h:99-100), so the first update's
bias correction is 1-b1, and epsilon sits INSIDE the sqrt:

    W -= lr * (m / (1 - b1_t)) / sqrt(v / (1 - b2_t) + eps)

``torch.optim`` has other rules (Adam: powers from 1, eps outside the
sqrt; SGD: another place for the decay), so it is not used. The updates
are in place on the parameters, which keeps one copy of the weights and
the state on the device.

A parameter that autograd gave no gradient counts as one with a zero
gradient, as ``jax.grad`` hands it: with weight decay or momentum a zero
gradient still moves the weight, so such a parameter is not skipped.
"""

from __future__ import annotations

import numpy as np
import torch


class _Optimizer:
    """Parameter list, per-parameter state buffers and the gradient
    convention shared by every rule. ``BUFFERS`` and ``SCALARS`` name a
    rule's state as the JAX package's state tuples do (``AdamState.m``,
    ``.b1_t`` ...): per-parameter buffers, in the order of
    ``self.buffers``, and float32 scalars held as attributes."""

    BUFFERS: tuple = ()
    SCALARS: tuple = ()

    def __init__(self, params, n_buffers: int):
        self.params = list(params)
        self.buffers = [[torch.zeros_like(p) for p in self.params]
                        for _ in range(n_buffers)]

    def state_dict(self) -> dict:
        """The rule's state by name: a list of tensors per buffer, a
        tensor per scalar."""
        state = {name: list(buf) for name, buf in zip(self.BUFFERS, self.buffers)}
        state.update({name: getattr(self, name) for name in self.SCALARS})
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` into the buffers in place, onto their
        device; raises on a missing name or another shape."""
        for name, buf in zip(self.BUFFERS, self.buffers):
            if len(state[name]) != len(buf):
                raise ValueError(f"{name}: {len(state[name])} tensors for "
                                 f"{len(buf)} parameters")
            for dst, src in zip(buf, state[name]):
                if dst.shape != src.shape:
                    raise ValueError(f"{name}: shape {tuple(src.shape)} for "
                                     f"a parameter of {tuple(dst.shape)}")
                dst.copy_(src)
        for name in self.SCALARS:
            setattr(self, name, self._scalar(float(state[name])))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _scalar(self, value: float) -> torch.Tensor:
        """A float32 scalar on the parameters' device, like the reference
        state."""
        dev = self.params[0].device if self.params else None
        return torch.tensor(value, dtype=torch.float32, device=dev)

    def _rows(self):
        """(parameter, gradient, *state buffers) per parameter."""
        for i, p in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            yield (p, g, *(b[i] for b in self.buffers))


class Adam(_Optimizer):
    BUFFERS, SCALARS = ("m", "v"), ("b1_t", "b2_t")

    def __init__(self, params, lr: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, 2)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.v = self.buffers
        self.b1_t, self.b2_t = self._scalar(b1), self._scalar(b2)

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.b1, self.b2
        c1, c2 = 1 - self.b1_t, 1 - self.b2_t
        for p, g, m, v in self._rows():
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.sub_(self.lr * (m / c1) / torch.sqrt(v / c2 + self.eps))
        self.b1_t = self.b1_t * b1
        self.b2_t = self.b2_t * b2


class SGD(_Optimizer):
    """gradient_descent (optimizer.cpp:50-54): W -= lr*(dW + lambda*W)."""

    def __init__(self, params, lr: float = 0.01, weight_decay: float = 0.0):
        super().__init__(params, 0)
        self.lr, self.weight_decay = lr, weight_decay

    @torch.no_grad()
    def step(self) -> None:
        for p, g in self._rows():
            p.sub_(self.lr * (g + self.weight_decay * p))


class Momentum(_Optimizer):
    """momentum (optimizer.cpp:57-66): V = mu*V - lr*(dW + W*lambda);
    W += V."""

    BUFFERS = ("dw_prev",)

    def __init__(self, params, lr: float = 0.01, mu: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, 1)
        self.lr, self.mu, self.weight_decay = lr, mu, weight_decay
        (self.dw_prev,) = self.buffers

    @torch.no_grad()
    def step(self) -> None:
        for p, g, vel in self._rows():
            vel.copy_(self.mu * vel - self.lr * (g + p * self.weight_decay))
            p.add_(vel)


class Nesterov(Momentum):
    """nesterov_momentum (optimizer.cpp:66-74):
    V = mu*Vprev - lr*(dW + W*lambda); W += -mu*Vprev + (1+mu)*V."""

    @torch.no_grad()
    def step(self) -> None:
        for p, g, vel in self._rows():
            new = self.mu * vel - self.lr * (g + p * self.weight_decay)
            p.copy_(p - self.mu * vel + (1 + self.mu) * new)
            vel.copy_(new)


class Adagrad(_Optimizer):
    """adagrad (optimizer.cpp:4-11): g2 += dW^2;
    W -= lr*dW/(sqrt(g2)+eps)."""

    BUFFERS = ("g2",)

    def __init__(self, params, lr: float = 0.01, eps: float = 1e-8):
        super().__init__(params, 1)
        self.lr, self.eps = lr, eps
        (self.g2,) = self.buffers

    @torch.no_grad()
    def step(self) -> None:
        for p, g, g2 in self._rows():
            g2.add_(g * g)
            p.sub_(self.lr * g / (torch.sqrt(g2) + self.eps))


class RMSprop(_Optimizer):
    """RMSprop (optimizer.cpp:13-20): g2 = mu*g2+(1-mu)dW^2;
    W -= lr*dW/sqrt(g2+eps)."""

    BUFFERS = ("g2",)

    def __init__(self, params, lr: float = 0.0001, mu: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, 1)
        self.lr, self.mu, self.eps = lr, mu, eps
        (self.g2,) = self.buffers

    @torch.no_grad()
    def step(self) -> None:
        for p, g, g2 in self._rows():
            g2.copy_(self.mu * g2 + (1 - self.mu) * g * g)
            p.sub_(self.lr * g / torch.sqrt(g2 + self.eps))


class Adamax(_Optimizer):
    """adamax (optimizer.cpp:37-48)."""

    BUFFERS, SCALARS = ("m", "u"), ("b1_t",)

    def __init__(self, params, lr: float = 0.002, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, 2)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m, self.u = self.buffers
        self.b1_t = self._scalar(b1)

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.b1, self.b2
        scale = self.lr / (1 - self.b1_t)
        for p, g, m, u in self._rows():
            m.copy_(b1 * m + (1 - b1) * g)
            u.copy_(torch.maximum(b2 * u, g.abs()))
            p.sub_(scale * (m / (u + self.eps)))
        self.b1_t = self.b1_t * b1


OPTIMIZERS = {
    "adam": Adam,
    "sgd": SGD,
    "momentum": Momentum,
    "nesterov": Nesterov,
    "adagrad": Adagrad,
    "rmsprop": RMSprop,
    "adamax": Adamax,
}


def opt_state_from_jax(opt: _Optimizer, jax_opt_state) -> None:
    """Load into ``opt`` the state of the JAX package's optimizer of the
    same rule, given as numpy arrays (``jax.tree.map(np.asarray, state)``:
    an ``AdamState``, ``MomentumState`` ... or a dict of its fields). A
    per-parameter field is a pytree shaped like the JAX parameters, read
    in the port's parameter order (``layers.leaves_in_param_order``), which
    is the order of the parameters ``opt`` was built on."""
    from graphaibench_tpu_torch.nn.layers import leaves_in_param_order

    fields = (jax_opt_state._asdict() if hasattr(jax_opt_state, "_asdict")
              else dict(jax_opt_state))
    state = {name: [torch.tensor(np.asarray(a, np.float32))
                    for a in leaves_in_param_order(fields[name])]
             for name in opt.BUFFERS}
    state.update({name: float(np.asarray(fields[name])) for name in opt.SCALARS})
    opt.load_state_dict(state)
