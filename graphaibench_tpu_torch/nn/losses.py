"""Masked loss layers with the reference semantics.

Counterpart of ``graphaibench_tpu/nn/losses.py``:
  * softmax CE over the mask range [begin, end), summed then divided by
    (end - begin) for the GRADIENT (softmax_loss_layer.cpp:31), while the
    REPORTED loss averages over the valid count (softmax_loss_layer.cpp:
    39-55);
  * sigmoid CE for multi-label, with the same conventions.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops import math as gmath


def _range_and_mask(nv: int, begin: int, end: int, mask, device):
    idx = torch.arange(nv, device=device)
    in_range = (idx >= begin) & (idx < end)
    if mask is not None:
        in_range = in_range & (mask != 0)
    return in_range


def masked_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                        begin: int, end: int, mask=None):
    """Returns (loss_for_grad, reported_loss, probs).

    loss_for_grad: sum(CE)/(end-begin) — its gradient is the reference's
    reported_loss: sum(CE)/count       — what the reference prints
    """
    nv, ncls = logits.shape
    valid = _range_and_mask(nv, begin, end, mask, logits.device)
    probs = torch.softmax(logits, dim=-1)
    # jax.nn.one_hot semantics: a label outside [0, ncls) is an all-zero
    # row (the reference reader's synthesized labels reach ncls)
    classes = torch.arange(ncls, device=logits.device)
    onehot = (labels.long()[:, None] == classes).to(logits.dtype)
    ce = gmath.cross_entropy(onehot, probs)
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    total = ce.sum()
    count = valid.sum().clamp(min=1)
    denom = max(end - begin, 1)
    return total / denom, total / count, probs


def masked_sigmoid_loss(logits: torch.Tensor, labels: torch.Tensor,
                        begin: int, end: int, mask=None):
    """Multi-label sigmoid CE with the same range/count conventions;
    ``labels`` is (nv, ncls) multi-hot."""
    nv, _ = logits.shape
    valid = _range_and_mask(nv, begin, end, mask, logits.device)
    ce = gmath.sigmoid_cross_entropy_with_logits(
        labels.to(logits.dtype), logits).sum(-1)
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    total = ce.sum()
    count = valid.sum().clamp(min=1)
    denom = max(end - begin, 1)
    return total / denom, total / count, torch.sigmoid(logits)
