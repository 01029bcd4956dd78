"""The collectives of feature-dimension tensor parallelism, each an
autograd function whose backward is written out.

Counterpart of ``_tp_matmul``, ``_sum_cotangent`` and ``_tp_scalar_dot``
of ``graphaibench_tpu/parallel/train.py``. A rank of a model group of M
ranks holds a column block, (n, ceil(F / M)), of the activations of its
vertex block, and multiplies it by its own row block of a replicated,
zero-padded weight, so that the weights' gradients are block-distinct
over the model group and one sum over the ranks assembles them.

Two all-reduces with two different backwards:

  * ``tp_matmul(..., scatter=False)`` (the classifier's logits): the
    forward sums the partial products over the model group; the backward
    is the identity. Every model rank feeds the same replicated logits to
    the same loss, and a rank back-propagates only its own copy of that
    loss, so the cotangent it receives is already the whole one; summing
    the M copies would count the loss M times.
  * ``tp_replicated_sum`` (the attention scalars' inner products, and
    the squared row norms of ``use_l2norm``): the forward sums the
    partials; the backward sums the cotangents over the model group
    (Megatron's "f" after the sum). The replicated sum is consumed
    blockwise: each rank's cotangent covers only its own column block's
    use of it, and the true cotangent is their sum.

``tp_matmul(..., scatter=True)`` reduce-scatters the partial products
over the H columns (padded to a multiple of M) and all-gathers the
cotangent's column blocks in its backward. Its route, ``REDUCE_SCATTER``,
is one for every backend: ``torch.distributed.reduce_scatter_tensor``.
gloo with CUDA tensors stages every collective through host buffers, as
``halo.py`` does (``multihost.transport``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from graphaibench_tpu_torch.parallel.halo import all_reduce_sum
from graphaibench_tpu_torch.parallel.multihost import transport

# the model axis's name in the JAX package, kept for its readers: here the
# model group of parallel.multihost.hybrid_groups takes its place
MODEL_AXIS = "model"
REDUCE_SCATTER = "reduce_scatter_tensor"


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def column_block(x: torch.Tensor, m: int, m_n: int) -> torch.Tensor:
    """Block ``m`` of ``m_n`` of x's columns, zero-padded to ceil(F / m_n)
    columns, as a contiguous tensor (a kernel's wrapper wants one)."""
    blk = _ceil_div(x.shape[1], m_n)
    x = F.pad(x, (0, blk * m_n - x.shape[1]))
    return x[:, m * blk:(m + 1) * blk].contiguous()


def reduce_scatter_cols(x: torch.Tensor, group) -> torch.Tensor:
    """Column block r of the sum of ``x`` (n, H) over the group's ranks,
    to rank r; H a multiple of the group's size."""
    m_n = dist.get_world_size(group)
    n, h = x.shape
    # the blocks one after the other on dim 0, where
    # reduce_scatter_tensor splits its input (gloo takes no stack)
    blk = h // m_n
    cat = x.reshape(n, m_n, blk).transpose(0, 1).reshape(m_n * n, blk)
    if transport(group, x.device) == "host-staged":
        cat = cat.cpu()
    out = cat.new_empty((n, blk))
    dist.reduce_scatter_tensor(out, cat, group=group)
    return out.to(x.device)


def all_gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's column block ``x`` (n, b), side by side in rank order:
    (n, b * ranks)."""
    m_n = dist.get_world_size(group)
    src = x.detach().contiguous()
    if transport(group, x.device) == "host-staged":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(m_n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=1).to(x.device)


class _ReduceScatterCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_cols(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_gather_cols(ct, ctx.group), None


class _SumIdentityBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _SumSumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ct, ctx.group), None


def _row_block(w: torch.Tensor, blk: int, group) -> torch.Tensor:
    """This rank's block of ``blk`` rows of ``w`` (any dims after the
    first), the rows zero-padded to blk x ranks: zero rows add nothing,
    and autograd slices their gradients away."""
    m_n, m_i = dist.get_world_size(group), dist.get_rank(group)
    pad = [0, 0] * (w.dim() - 1) + [0, blk * m_n - w.shape[0]]
    return F.pad(w, pad)[m_i * blk:(m_i + 1) * blk]


def tp_matmul(h_m: torch.Tensor, w: torch.Tensor, group, *,
              scatter: bool) -> torch.Tensor:
    """h (n, F) @ w (F, H) with h column-blocked over ``group``: ``h_m``
    is this rank's block. With ``scatter`` the result is this rank's
    column block of the product, (n, ceil(H / M)), the H columns padded
    with zeros (they ride through the elementwise ops and meet the next
    weight's zero pad rows); without, the whole product on every rank."""
    partial = h_m @ _row_block(w, h_m.shape[1], group)
    if not scatter:
        return _SumIdentityBackward.apply(partial, group)
    m_n = dist.get_world_size(group)
    partial = F.pad(partial, (0, _ceil_div(w.shape[1], m_n) * m_n
                              - w.shape[1]))
    return _ReduceScatterCols.apply(partial, group)


def tp_replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partials ``x``, replicated, whose cotangent
    is summed over the group on the way back (see the module's note)."""
    return _SumSumBackward.apply(x, group)


def tp_scalar_dot(t_m: torch.Tensor, vec: torch.Tensor, group) -> torch.Tensor:
    """<t, vec> per row with t column-blocked over ``group``: the sum of
    the per-block partial products, ``vec``'s rows padded to the block
    grid as ``tp_matmul``'s weight is."""
    return tp_replicated_sum(t_m @ _row_block(vec, t_m.shape[1], group),
                             group)
