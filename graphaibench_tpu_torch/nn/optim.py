"""The reference's Adam, written out by hand.

Counterpart of ``graphaibench_tpu/nn/optim.py::Adam``. The reference keeps
running decay powers that START at b1/b2 (optimizer.h:99-100), so the
first update's bias correction is 1-b1, and epsilon sits INSIDE the sqrt:

    W -= lr * (m / (1 - b1_t)) / sqrt(v / (1 - b2_t) + eps)

``torch.optim.Adam`` is a different rule (powers from 1, eps outside the
sqrt), so it is not used. The update is in place on the parameters,
which keeps one copy of the weights and the moments on the device. The
other optimizers of the reference are ROADMAP item P4.
"""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params, lr: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device if self.params else None
        # float32 scalars on the device, like the reference state
        self.b1_t = torch.tensor(b1, dtype=torch.float32, device=dev)
        self.b2_t = torch.tensor(b2, dtype=torch.float32, device=dev)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.b1, self.b2
        c1, c2 = 1 - self.b1_t, 1 - self.b2_t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                raise ValueError("Adam.step: a parameter has no gradient")
            g = p.grad
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.sub_(self.lr * (m / c1) / torch.sqrt(v / c2 + self.eps))
        self.b1_t = self.b1_t * b1
        self.b2_t = self.b2_t * b2
