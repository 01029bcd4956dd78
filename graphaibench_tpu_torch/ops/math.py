"""Elementwise / reduction math matching the reference semantics.

Counterpart of ``graphaibench_tpu/ops/math.py``: the ops whose exact
semantics matter for parity (cross-entropy clamp, masked accuracy,
dropout scaling, the l2norm clamp).
"""

from __future__ import annotations

import torch


def leaky_relu(x: torch.Tensor, epsilon: float = 0.2) -> torch.Tensor:
    return torch.where(x > 0, x, epsilon * x)


def cross_entropy(y: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Row-wise CE with the reference's clamp: p == 0 contributes
    -y*log(1e-10). y is one/multi-hot."""
    logp = torch.log(torch.where(p == 0.0, torch.full_like(p, 1e-10), p))
    return -(y * logp).sum(-1)


def sigmoid_cross_entropy_with_logits(y: torch.Tensor,
                                      logits: torch.Tensor) -> torch.Tensor:
    """Per-element numerically stable sigmoid CE (the TF formulation)."""
    return (torch.clamp(logits, min=0.0) - logits * y
            + torch.log1p(torch.exp(-logits.abs())))


def dropout(generator: torch.Generator, x: torch.Tensor,
            rate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep with probability 1-rate, scale kept values by 1/(1-rate).
    Returns (out, keep). The bits come from ``generator``, not from the
    JAX key stream, so the two packages drop different entries."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    scale = 1.0 / (1.0 - rate)
    return torch.where(keep, x * scale, torch.zeros_like(x)), keep


def masked_accuracy_single(preds: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Fraction of masked vertices whose argmax matches the label."""
    m = mask != 0
    correct = (preds.argmax(-1) == labels) & m
    return correct.sum() / m.sum().clamp(min=1)


def masked_f1_micro(probs: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Micro-F1 over masked vertices for multi-label tasks."""
    m = (mask != 0)[:, None]
    pred = (probs > threshold) & m
    true = (labels != 0) & m
    tp = (pred & true).sum()
    fp = (pred & ~true).sum()
    fn = (~pred & true).sum()
    precision = tp / (tp + fp).clamp(min=1)
    recall = tp / (tp + fn).clamp(min=1)
    return 2 * precision * recall / (precision + recall).clamp(min=1e-10)


def l2norm_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization; the squared sum is clamped at 1e-12
    before the sqrt."""
    sum_x2 = (x * x).sum(-1, keepdim=True).clamp(min=eps)
    return x / torch.sqrt(sum_x2)
