"""The halo exchange and the sharded aggregation built on it.

Counterpart of ``graphaibench_tpu/parallel/halo.py``. Between layers each
rank sends the owned rows that its peers read to them, with one
all-to-all, and then aggregates locally over its own rows and the halo it
received. JAX differentiates its ``all_to_all`` by itself; here
``halo_exchange`` is an autograd function whose backward is written out:
the halo's cotangent is added into a receive-shaped buffer by
``halo_map``, goes back with the reverse all-to-all, and is added into the
owned rows by ``send_idx``. An owned row may be in several peers' send
lists, so the backward adds, never stores; the padding entries of
``send_idx`` and ``halo_map`` are 0 and only ever carry zeros (a halo pad
row is read by no edge, so its cotangent is zero).

Every rank calls the exchange, forward and backward, the same number of
times in the same order: the trainer's layers do, and the aggregations
after it keep its output in the autograd graph even where a rank's halo
table is empty.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from graphaibench_tpu_torch.parallel.multihost import transport
from graphaibench_tpu_torch.parallel.shard_ell import (
    build_rank_tables,
    slot_spmm_packed,
)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Chunk q of ``x`` (split evenly along dim 0) to rank q; chunk p of
    the result from rank p. gloo with CUDA tensors goes through host
    buffers (``multihost.transport``)."""
    x = x.contiguous()
    if transport(group, x.device) == "host-staged":
        out = torch.empty(x.shape, dtype=x.dtype)
        dist.all_to_all_single(out, x.cpu(), group=group)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; host-staged as
    ``all_to_all``)."""
    if transport(group, x.device) == "host-staged":
        y = x.detach().cpu().clone()
        dist.all_reduce(y, group=group)
        return y.to(x.device)
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks), concatenated along dim
    0 in rank order."""
    n = dist.get_world_size(group)
    staged = transport(group, x.device) == "host-staged"
    src = x.detach().cpu() if staged else x.detach()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts).to(x.device)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_own, send_idx, halo_map, group):
        ctx.nv_pad, ctx.group = x_own.shape[0], group
        ctx.save_for_backward(send_idx, halo_map)
        send = x_own[send_idx.reshape(-1)]          # (P * s_max, F)
        return all_to_all(send, group)[halo_map]    # (h_max, F)

    @staticmethod
    def backward(ctx, ct):
        send_idx, halo_map = ctx.saved_tensors
        flat = ct.new_zeros((send_idx.numel(), ct.shape[1]))
        flat.index_add_(0, halo_map, ct)
        back = all_to_all(flat, ctx.group)
        d_x = ct.new_zeros((ctx.nv_pad, ct.shape[1]))
        d_x.index_add_(0, send_idx.reshape(-1), back)
        return d_x, None, None, None


def halo_exchange(x_own: torch.Tensor, send_idx: torch.Tensor,
                  halo_map: torch.Tensor, group=None) -> torch.Tensor:
    """x_halo (h_max, F): the remote rows this rank reads. ``x_own``
    (nv_pad, F) are its owned rows, ``send_idx`` (P, s_max) the owned rows
    it sends to each rank, ``halo_map`` (h_max,) the slot of each halo row
    in the flattened receive buffer (P * s_max rows)."""
    return _HaloExchange.apply(x_own, send_idx.long(), halo_map.long(), group)


def sharded_spmm_local(edge_src: torch.Tensor, col_idx: torch.Tensor,
                       w: torch.Tensor, x_ext: torch.Tensor,
                       nv_pad: int) -> torch.Tensor:
    """Aggregation by gather and ``index_add_`` over the rank's slot
    arrays (the route ``use_ell=False`` selects); padding slots have
    weight 0."""
    msgs = x_ext[col_idx.long()] * w[:, None]
    return x_ext.new_zeros((nv_pad, x_ext.shape[1])).index_add_(
        0, edge_src.long(), msgs)


def static_aggregator(ga: dict, ell: dict, nv_pad: int, group=None):
    """f(x_own) -> this rank's aggregated rows (nv_pad, F) with the static
    slot weights. ``ga`` holds the rank's ``send_idx`` and ``halo_map``
    (and on the plain route its slot arrays ``edge_src``, ``col_idx``,
    ``edge_w``); ``ell`` maps a part to (ShardEll, ShardPackedW). With
    "own" in ``ell``: K1 over the own and the halo tables (the own rows'
    part needs no halo); with "all": K1 over the unified table of the
    extended rows; with neither: gather and ``index_add_``."""

    def spmm_fn(x_own: torch.Tensor) -> torch.Tensor:
        # an empty halo table still takes the halo into the autograd
        # graph, so every rank runs the exchange's backward
        x_halo = halo_exchange(x_own, ga["send_idx"], ga["halo_map"], group)
        if "own" in ell:
            return (slot_spmm_packed(nv_pad, *ell["own"], x_own)
                    + slot_spmm_packed(nv_pad, *ell["halo"], x_halo))
        x_ext = torch.cat([x_own, x_halo])
        if "all" in ell:
            return slot_spmm_packed(nv_pad, *ell["all"], x_ext)
        return sharded_spmm_local(ga["edge_src"], ga["col_idx"],
                                  ga["edge_w"], x_ext, nv_pad)

    return spmm_fn


def rank_graph_arrays(shard, *, plain: bool, device="cpu") -> dict:
    """The rank's halo plan on ``device`` (``shard`` a
    ``partition.RankShard``), with its slot arrays (``edge_src``,
    ``col_idx``, ``edge_w``, ``edge_valid``) where the plain route reads
    them."""
    names = ("send_idx", "halo_map") + (
        ("edge_src", "col_idx", "edge_w", "edge_valid") if plain else ())
    out = {}
    for k in names:
        a = np.ascontiguousarray(getattr(shard, k))
        t = torch.from_numpy(a).to(device)
        out[k] = t.long() if a.dtype == np.int32 else t
    return out


def make_sharded_spmm(sg, rank: int, *, group=None, device="cpu",
                      use_ell: bool = True, overlap: bool = True):
    """f(x_own) -> this rank's aggregated rows (nv_pad, F), for the host
    ShardedGraph ``sg`` (``static_aggregator``): by default K1 over the
    own and the halo tables; with ``overlap=False`` over the unified
    table; with ``use_ell=False`` by gather and ``index_add_``."""
    shard = sg.shard(rank)
    parts = (("own", "halo") if overlap else ("all",)) if use_ell else ()
    ell = build_rank_tables(shard, parts, with_trans=False, device=device)
    ga = rank_graph_arrays(shard, plain=not use_ell, device=device)
    return static_aggregator(ga, ell, sg.nv_pad, group)
