"""Sharded full-batch GNN training, one process per rank.

Counterpart of the 1-D trainer of ``graphaibench_tpu/parallel/train.py``:
vertex-sharded features, each rank's local tables with a halo exchange
between layers (``parallel/halo.py``), replicated weights whose gradients
are summed over the ranks before the optimizer's step. Where the JAX
package runs one ``shard_map`` program over a mesh, the port runs one
process per rank in a ``torch.distributed`` group (``parallel/multihost.py``
starts them), each building and holding only its own shard.

GCN, SAGE and GGNN aggregate with static weights by K1 over the own/halo
split (the own rows' part needs no halo); GAT runs the fused attention v2
over the unified table of its own and halo rows. ``use_ell=False`` takes
the plain gather and ``index_add_`` route, ``overlap=False`` the unified
table for the static weights as well.

Not ported: ``train_steps`` (the JAX trainer's ``lax.scan`` batching of
steps into one dispatch, an answer to its device's dispatch cost) and the
tensor-parallel trainer ``make_tp_trainer`` (ROADMAP, P14b).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from graphaibench_tpu_torch.nn.layers import ModelConfig, matmul
from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.parallel.halo import (
    all_gather_rows,
    all_reduce_sum,
    halo_exchange,
    rank_graph_arrays,
    sharded_spmm_local,
    static_aggregator,
)
from graphaibench_tpu_torch.parallel.multihost import transport
from graphaibench_tpu_torch.parallel.partition import ShardedGraph, pad_rows
from graphaibench_tpu_torch.parallel.shard_ell import (
    build_rank_tables,
    gat_fused_local_v2,
)


def _local_segment_softmax(edge_src, logits, valid, nv_pad):
    """Per-local-row softmax over the rank's slots (a row's edges never
    cross ranks); padding slots are masked. The row max is a constant of
    the softmax, so no gradient flows through it."""
    neg = torch.finfo(logits.dtype).min
    lg = torch.where(valid, logits, torch.full_like(logits, neg))
    row_max = lg.new_full((nv_pad,), float("-inf")).scatter_reduce(
        0, edge_src, lg.detach(), "amax")
    e = torch.where(valid, torch.exp(lg - row_max[edge_src]),
                    torch.zeros_like(lg))
    denom = e.new_zeros(nv_pad).index_add(0, edge_src, e)
    return e / torch.clamp(denom[edge_src], min=1e-30)


def _make_aggregators(ga, ell, nv_pad, group):
    """The rank's aggregation closures (``_make_aggregators`` of the JAX
    module): ``exchange`` (the extended rows: own, then halo),
    ``aggregate_w`` (the plain route, on per-slot weights) and
    ``aggregate`` (static weights, ``halo.static_aggregator``)."""

    def exchange(h):
        return torch.cat([h, halo_exchange(h, ga["send_idx"], ga["halo_map"],
                                           group)])

    def aggregate_w(h_ext, w):
        return sharded_spmm_local(ga["edge_src"], ga["col_idx"], w, h_ext,
                                  nv_pad)

    return exchange, aggregate_w, static_aggregator(ga, ell, nv_pad, group)


def _local_gconv_forward(cfg: ModelConfig, params, ga, x_own, *, group=None,
                         ell=None):
    """The rank's forward of the gconv stack: logits of its owned rows.
    ``ell`` maps a part ("own", "halo", "all") to (ShardEll,
    ShardPackedW or None); an empty dict takes the plain route."""
    nv_pad = x_own.shape[0]
    exchange, aggregate_w, aggregate = _make_aggregators(ga, ell, nv_pad,
                                                         group)
    h = x_own
    for l, (din, dout, act) in enumerate(cfg.gconv_dims):
        p = params.gconv[l]
        if cfg.arch == "gat":
            # project, exchange the projected rows, rank-1 logits, a
            # softmax over each local row, the score-weighted aggregation
            t = matmul(h, p.W_neigh)
            t_ext = exchange(t)
            sl = t @ p.alpha_l
            sr = t_ext @ p.alpha_r
            if "all" in ell:
                out = gat_fused_local_v2(nv_pad, ell["all"][0], sl, sr, t_ext)
            else:
                src, col = ga["edge_src"], ga["col_idx"]
                logits = gmath.leaky_relu(sl[src] + sr[col], 0.2)
                scores = _local_segment_softmax(src, logits, ga["edge_valid"],
                                                nv_pad)
                out = aggregate_w(t_ext, scores)
        elif cfg.arch == "ggnn":
            t = h
            if t.shape[1] != p.W_neigh.shape[1]:
                t = matmul(t, p.W_neigh)
            a = aggregate(t)
            z = torch.sigmoid(matmul(a, p.Wz) + matmul(t, p.Uz))
            r = torch.sigmoid(matmul(a, p.Wr) + matmul(t, p.Ur))
            hcand = torch.tanh(matmul(a, p.Wh) + matmul(r * t, p.Uh))
            out = (1 - z) * t + z * hcand
        elif din > dout:
            out = aggregate(matmul(h, p.W_neigh))
        else:
            out = matmul(aggregate(h), p.W_neigh)
        if cfg.arch == "sage":
            out = out + matmul(h, p.W_self)
        h = torch.relu(out) if act else out
    if cfg.use_l2norm:
        h = gmath.l2norm_rows(h)
    if cfg.use_dense:
        h = matmul(h, params.dense.W)
    return h


@dataclasses.dataclass
class ShardedTrainer:
    """One rank's train and eval functions, bound to its process group and
    shard. Every function is collective: all ranks call it together."""

    # the process group (the JAX trainer's mesh)
    mesh: object
    # (params, opt) -> loss: one step, parameters updated in place; the
    # loss (a 0-d tensor) is the reported one, sum of CE / valid count
    train_step: Callable
    # (params) -> (nv, C) logits of every vertex, on every rank
    eval_logits: Callable
    nv: int
    # () -> seconds of one dim_hid-wide halo exchange alone, device-synced:
    # the `halo` row of the --timers breakdown
    halo_probe: Callable = None
    # (params, which) -> masked single-class accuracy from counts summed
    # over the ranks, for the names of eval_ranges ("val", "test")
    eval_accuracy: Callable = None
    # how the collectives move tensors (multihost.transport)
    transport: str = "device"


def make_sharded_trainer(
    cfg: ModelConfig,
    sg: ShardedGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    train_range: tuple[int, int, int],
    train_mask: np.ndarray,
    *,
    group=None,
    device="cpu",
    use_ell: bool = True,
    overlap: bool = True,
    eval_ranges: dict | None = None,
) -> ShardedTrainer:
    """This process's rank of the trainer over ``sg``, whose shard count
    must be the group's size. ``device`` is the rank's device. The rank
    ships only its rows of the features, labels and masks, its halo plan,
    and the tables it consumes: the own/halo split for static weights
    with ``overlap``, else the unified table (GAT's, with its transpose
    and no packed weights); none on the plain route, which keeps the slot
    arrays instead.

    ``eval_ranges`` maps a name ("val", "test") to a (range, mask) pair;
    each becomes the rank's rows of a validity mask."""
    if sg.num_shards != dist.get_world_size(group):
        raise ValueError(f"{sg.num_shards} shards for a group of "
                         f"{dist.get_world_size(group)} ranks")
    rank = dist.get_rank(group)
    device = torch.device(device)
    begin, end, _count = train_range
    nv, nv_total, nv_pad = sg.nv, sg.padded_nv, sg.nv_pad
    mine = slice(rank * nv_pad, (rank + 1) * nv_pad)
    idx = np.arange(nv)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def _valid(rng_, mask):
        b, e, _ = rng_
        v = (idx >= b) & (idx < e)          # GLOBAL id ranges
        v = v & (np.asarray(mask)[:nv] != 0)
        return pad_rows(v, nv_total, sg.perm)

    valid_all = _valid(train_range, train_mask)
    count = max(int(valid_all.sum()), 1)
    packed = use_ell and cfg.arch != "gat"
    parts = (("own", "halo") if packed and overlap
             else ("all",) if use_ell else ())
    ga = rank_graph_arrays(sg, rank, plain=not use_ell, device=device)
    ell = build_rank_tables(sg, rank, parts, packed=packed, device=device)
    x_own = put(pad_rows(np.asarray(feats, np.float32), nv_total,
                         sg.perm)[mine])
    lab = put(pad_rows(np.asarray(labels).astype(np.int64), nv_total,
                       sg.perm)[mine])
    valid = put(valid_all[mine])
    eval_masks = {k: put(_valid(rng_, m)[mine])
                  for k, (rng_, m) in (eval_ranges or {}).items()}
    perm = (None if sg.perm is None
            or np.array_equal(sg.perm, np.arange(nv)) else put(sg.perm))
    classes = torch.arange(cfg.num_cls, device=device)

    def forward(params):
        return _local_gconv_forward(cfg, params, ga, x_own, group=group,
                                    ell=ell)

    def train_step(params, opt):
        opt.zero_grad()
        logits = forward(params)
        probs = torch.softmax(logits, dim=-1)
        # a label outside [0, classes) has an all-zero row, as one_hot gives it
        onehot = (lab[:, None] == classes).to(logits.dtype)
        ce = gmath.cross_entropy(onehot, probs)
        local = torch.where(valid, ce, torch.zeros_like(ce)).sum()
        # reference gradient scaling: / (end - begin)
        (local / max(end - begin, 1)).backward()
        # one sum over the ranks for every gradient and the loss
        ps = list(params.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps]
                         + [local.detach().reshape(1)])
        flat = all_reduce_sum(flat, group)
        off = 0
        for p in ps:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        opt.step()
        return flat[-1] / count

    @torch.no_grad()
    def eval_logits(params):
        rows = all_gather_rows(forward(params), group)
        return rows[perm] if perm is not None else rows[:nv]

    @torch.no_grad()
    def eval_accuracy(params, which: str = "val") -> float:
        vmask = eval_masks[which]
        pred = forward(params).argmax(-1)
        counts = torch.stack([(vmask & (pred == lab)).sum(), vmask.sum()])
        c, t = all_reduce_sum(counts, group).tolist()
        return float(c) / max(float(t), 1.0)

    probe_w = min(cfg.dim_hid, x_own.shape[1])   # a layer's activation width
    probe_x = x_own[:, :probe_w].contiguous()

    @torch.no_grad()
    def halo_probe() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        float(halo_exchange(probe_x, ga["send_idx"], ga["halo_map"],
                            group).sum())   # float() waits for the device
        return time.perf_counter() - t0

    return ShardedTrainer(
        mesh=group, train_step=train_step, eval_logits=eval_logits, nv=nv,
        halo_probe=halo_probe, eval_accuracy=eval_accuracy,
        transport=transport(group, device))
