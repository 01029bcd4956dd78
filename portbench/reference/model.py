"""The plain reference of a configuration's training steps, in PyTorch.

It takes the raw graph (the benchmark's CSR arrays) and the inputs the
benchmark made from the seed, and works out again everything the program
derives: the self-loops and edge weights (the architecture's module beside
this file), the dropout masks from the handed seed, the masked softmax
cross-entropy, the gradients, and the reference trainer's Adam. It imports
nothing of the program.

The SpMM is an ``index_add_`` over blocks of edges (the gathered rows of a
block stay under ``BLOCK_ELEMS`` floats), its adjoint the same over the
transposed edges, so it fits beside a products-sized graph. The GEMMs run
in full float32; ``precision="tf32"`` gives the control, the same steps
with TF32 GEMMs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import numpy as np
import torch

BLOCK_ELEMS = 1 << 29


def arch_module(arch: str):
    """``reference/<arch>.py``: what the benchmark knows of an architecture:
    its layer, its weights' shapes, its edge weights and self-loops, and the
    work of its step."""
    return importlib.import_module(f"{__package__}.{arch}")


@dataclasses.dataclass
class RefGraph:
    src: torch.Tensor     # (E,) int64
    dst: torch.Tensor     # (E,) int64
    w: torch.Tensor       # (E,) float32
    nv: int

    @classmethod
    def build(cls, row_ptr: np.ndarray, col_idx: np.ndarray, arch,
              device) -> "RefGraph":
        rp = torch.from_numpy(np.asarray(row_ptr, np.int64)).to(device)
        dst = torch.from_numpy(np.asarray(col_idx)).to(device).long()
        nv = rp.numel() - 1
        deg = rp[1:] - rp[:-1]
        src = torch.repeat_interleave(torch.arange(nv, device=device), deg)
        if arch.SELF_LOOPS:
            loops = torch.arange(nv, device=device)
            src, dst, deg = (torch.cat([src, loops]), torch.cat([dst, loops]),
                             deg + 1)
        return cls(src, dst, arch.edge_weights(src, dst, deg), nv)

    def _apply(self, x: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((self.nv, x.shape[1]))
        step = max(1, BLOCK_ELEMS // max(x.shape[1], 1))
        for lo in range(0, rows.numel(), step):
            hi = lo + step
            out.index_add_(0, rows[lo:hi], x[cols[lo:hi]] * self.w[lo:hi, None])
        return out

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """out[s] = sum over edges s -> d of w * x[d]."""
        return self._apply(x, self.src, self.dst)

    def spmm_t(self, ct: torch.Tensor) -> torch.Tensor:
        """The adjoint: out[d] = sum over edges s -> d of w * ct[s]."""
        return self._apply(ct, self.dst, self.src)


class _Agg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return graph.spmm(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.graph.spmm_t(ct.contiguous()), None


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its mantissa rounded to TF32's 10 bits (nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _Tf32Matmul(torch.autograd.Function):
    """A GEMM on operands rounded to TF32, forward and backward: what the
    card's TF32 GEMMs compute, for a device that has none."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_tf32(a) @ _round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ _round_tf32(b).T, _round_tf32(a).T @ g


def _mm_for(precision: str):
    if precision == "float32":
        return torch.matmul
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")

    def mm(a, b):
        if a.is_cuda:    # the card's TF32 GEMMs, under the flag set around
            return a @ b
        return _Tf32Matmul.apply(a, b)
    return mm


@dataclasses.dataclass
class Trajectory:
    """What a run of the first steps gives: the reported loss of each step,
    the gradient of the first step, and the weights before and after."""

    losses: list
    grad1: dict
    w0: dict
    w_after: dict


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """The reference's dropout: keep with probability 1 - rate, scale by
    1 / (1 - rate); the masks drawn from ``gen`` over x's shape."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - rate)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def forward(cfg: dict, arch, weights: dict, graph: RefGraph, x: torch.Tensor,
            gen, mm, train: bool) -> torch.Tensor:
    m = cfg["model"]
    rate = m.get("feat_drop", 0.0)
    n = m["num_layers"]
    h = x
    for l in range(n):
        if train and rate > 0.0:
            h = dropout(h, rate, gen)
        w = {k.rsplit(".", 1)[1]: v for k, v in weights.items()
             if k.startswith(f"gconv.{l}.")}
        h = arch.layer(w, h, lambda t: _Agg.apply(t, graph), mm)
        if l < n - 1:
            h = torch.relu(h)
    return h


def softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over ``rows``; a probability of 0 counts as 1e-10."""
    p = torch.softmax(logits[rows], dim=-1)
    p = torch.where(p == 0.0, torch.full_like(p, 1e-10), p)
    return -torch.log(p).gather(1, labels[rows, None]).sum() / rows.numel()


class Adam:
    """The reference trainer's Adam: decay powers that start at b1 and b2,
    epsilon inside the square root."""

    def __init__(self, params: list, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        dev = params[0].device
        self.b1_t = torch.tensor(b1, dtype=torch.float32, device=dev)
        self.b2_t = torch.tensor(b2, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def step(self, grads: list) -> None:
        c1, c2 = 1 - self.b1_t, 1 - self.b2_t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            p.sub_(self.lr * (m / c1) / torch.sqrt(v / c2 + self.eps))
        self.b1_t = self.b1_t * self.b1
        self.b2_t = self.b2_t * self.b2


def train_steps(cfg: dict, graph: RefGraph, feats: torch.Tensor,
                labels: torch.Tensor, weights: dict, dropout_seed: int,
                steps: int, *, precision: str = "float32",
                rows: torch.Tensor | None = None) -> Trajectory:
    """``steps`` full-batch training steps from ``weights``. The loss is over
    the configuration's training vertices, or over ``rows`` where given
    (a fault check leaves some out)."""
    arch = arch_module(cfg["model"]["arch"])
    dev = feats.device
    if rows is None:
        rows = torch.arange(cfg["train_nodes"], device=dev)
    params = {k: w.detach().clone().requires_grad_(True)
              for k, w in weights.items()}
    names = list(params)
    opt = Adam([params[k] for k in names], lr=cfg["model"]["lr"])
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    mm = _mm_for(precision)
    losses, grad1 = [], None
    with _matmul_precision(precision):
        for i in range(steps):
            logits = forward(cfg, arch, params, graph, feats, gen, mm, True)
            loss = softmax_loss(logits, labels, rows)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            del logits
            losses.append(float(loss.detach()))
            if i == 0:
                grad1 = {k: g.detach().clone() for k, g in zip(names, grads)}
            opt.step(grads)
    return Trajectory(losses, grad1,
                      {k: w.detach().clone() for k, w in weights.items()},
                      {k: p.detach().clone() for k, p in params.items()})


@torch.no_grad()
def eval_accuracy(cfg: dict, graph: RefGraph, feats: torch.Tensor,
                  labels: torch.Tensor, weights: dict, rows: torch.Tensor,
                  precision: str = "float32") -> float:
    """The share of ``rows`` whose largest logit is at their label."""
    arch = arch_module(cfg["model"]["arch"])
    with _matmul_precision(precision):
        logits = forward(cfg, arch, weights, graph, feats, None,
                         _mm_for(precision), False)
    return float((logits[rows].argmax(-1) == labels[rows]).float().mean())
