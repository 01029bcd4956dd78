"""Sharded full-batch GNN training, one process per rank: the 1-D trainer
and the tensor-parallel one.

Counterpart of ``graphaibench_tpu/parallel/train.py``. The 1-D trainer
shards the vertices: each rank holds its vertex block's features, labels
and local tables, exchanges a halo between layers (``parallel/halo.py``)
and sums the replicated weights' gradients over the ranks before the
optimizer's step. The tensor-parallel trainer lays G x M ranks out as a
(graph x model) grid (``multihost.hybrid_groups``): the G vertex blocks
as above, and the feature dimension split over the M ranks of each
block, which hold column blocks of the activations (``parallel/tp.py``).
Where the JAX package runs one ``shard_map`` program over a mesh, the
port runs one process per rank in a ``torch.distributed`` group
(``parallel/multihost.py`` starts them), each building and holding only
its own shard.

GCN, SAGE and GGNN aggregate with static weights by K1 over the own/halo
split (the own rows' part needs no halo); GAT runs the fused attention v2
over the unified table of its own and halo rows. ``use_ell=False`` takes
the plain gather and ``index_add_`` route, ``overlap=False`` the unified
table for the static weights as well. Under tensor parallelism the same
tables run at the column blocks' widths.

Both trainers compute the model's gradient: each rank back-propagates
its own rows' loss once, and one sum over the ranks assembles the
gradients. (JAX's trainers give G x M times it, ROADMAP queue 3.)

Not ported: ``train_steps`` (the JAX trainer's ``lax.scan`` batching of
steps into one dispatch, an answer to its device's dispatch cost).
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
from graphaibench_tpu_torch.parallel.multihost import hybrid_groups, transport
from graphaibench_tpu_torch.parallel.partition import ShardedGraph, pad_rows
from graphaibench_tpu_torch.parallel.shard_ell import (
    build_rank_tables,
    gat_fused_local_v2,
)
from graphaibench_tpu_torch.parallel.tp import (
    column_block,
    tp_matmul,
    tp_replicated_sum,
    tp_scalar_dot,
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
    module), for any feature width: ``exchange`` (the extended rows: own,
    then halo), ``aggregate_w`` (the plain route, on per-slot weights)
    and ``aggregate`` (static weights, ``halo.static_aggregator``)."""

    def exchange(h):
        return torch.cat([h, halo_exchange(h, ga["send_idx"], ga["halo_map"],
                                           group)])

    def aggregate_w(h_ext, w):
        return sharded_spmm_local(ga["edge_src"], ga["col_idx"], w, h_ext,
                                  nv_pad)

    return exchange, aggregate_w, static_aggregator(ga, ell, nv_pad, group)


def _gat_aggregate(ga, ell, nv_pad, aggregate_w, sl, sr, t_ext):
    """GAT's score-weighted aggregation: the fused attention v2 on the
    unified table, or on the plain route rank-1 logits, the local
    softmax and ``aggregate_w``."""
    if "all" in ell:
        return gat_fused_local_v2(nv_pad, ell["all"][0], sl, sr, t_ext)
    src, col = ga["edge_src"], ga["col_idx"]
    logits = gmath.leaky_relu(sl[src] + sr[col], 0.2)
    scores = _local_segment_softmax(src, logits, ga["edge_valid"], nv_pad)
    return aggregate_w(t_ext, scores)


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
            out = _gat_aggregate(ga, ell, nv_pad, aggregate_w,
                                 t @ p.alpha_l, t_ext @ p.alpha_r, t_ext)
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


def _local_gconv_forward_tp(cfg: ModelConfig, params, ga, x_m, *,
                            graph_group, model_group, ell):
    """The tensor-parallel rank's forward: ``x_m`` is its column block of
    its vertex block's features (``tp.column_block``), the halo exchange
    runs over ``graph_group`` on column blocks, and every product with a
    weight is a ``tp_matmul`` over ``model_group``. Activations stay
    column-blocked between layers; the last gconv, where no dense head
    follows, and the dense head sum to replicated logits. GCN and SAGE
    take JAX's order (din > dout: multiply, then aggregate; else
    aggregate, then multiply); GAT projects scattered, exchanges the
    block, and forms its attention scalars by ``tp_scalar_dot``."""
    nv_pad = x_m.shape[0]
    exchange, aggregate_w, aggregate = _make_aggregators(ga, ell, nv_pad,
                                                         graph_group)
    h = x_m
    for l, (din, dout, act) in enumerate(cfg.gconv_dims):
        p = params.gconv[l]
        scatter = l < cfg.num_layers - 1 or cfg.use_dense
        if cfg.arch == "gat":
            t = tp_matmul(h, p.W_neigh, model_group, scatter=True)
            t_ext = exchange(t)
            out = _gat_aggregate(
                ga, ell, nv_pad, aggregate_w,
                tp_scalar_dot(t, p.alpha_l, model_group),
                tp_scalar_dot(t_ext, p.alpha_r, model_group), t_ext)
        elif din > dout:
            out = aggregate(tp_matmul(h, p.W_neigh, model_group,
                                      scatter=scatter))
        else:
            out = tp_matmul(aggregate(h), p.W_neigh, model_group,
                            scatter=scatter)
        if cfg.arch == "sage":
            out = out + tp_matmul(h, p.W_self, model_group, scatter=scatter)
        h = torch.relu(out) if act else out
    if cfg.use_l2norm:
        # a row's norm needs the whole row: h is column-blocked iff the
        # dense head follows (the last gconv then scattered)
        s2 = (h * h).sum(-1, keepdim=True)
        if cfg.use_dense:
            s2 = tp_replicated_sum(s2, model_group)
        h = h / torch.sqrt(torch.clamp(s2, min=1e-12))
    if cfg.use_dense:
        h = tp_matmul(h, params.dense.W, model_group, scatter=False)
    return h


@dataclasses.dataclass
class ShardedTrainer:
    """One rank's train and eval functions, bound to its process groups
    and shard. Every function is collective: all ranks call it together."""

    # the process group of the gradients' sum (the JAX trainer's mesh)
    mesh: object
    # (params, opt) -> loss: one step, parameters updated in place; the
    # loss (a 0-d tensor) is the reported one, sum of CE / valid count
    train_step: Callable
    # (params) -> (nv, C) logits of every vertex, on every rank
    eval_logits: Callable
    nv: int
    # () -> seconds of one halo exchange alone at a layer's activation
    # width (a column block's under tensor parallelism), device-synced:
    # the `halo` row of the --timers breakdown
    halo_probe: Callable = None
    # (params, which) -> masked single-class accuracy from counts summed
    # over the vertex blocks, for the names of eval_ranges ("val", "test")
    eval_accuracy: Callable = None
    # how the collectives move tensors (multihost.transport)
    transport: str = "device"


def prepare_trainer_host(
    cfg: ModelConfig,
    sg: ShardedGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    train_range: tuple[int, int, int],
    train_mask: np.ndarray,
    *,
    use_ell: bool = True,
    overlap: bool = True,
    eval_ranges: dict | None = None,
) -> dict:
    """What every rank is built from, on the host: the vertex rows laid
    out in the sharded row space (``x``, ``lab``, the training ``valid``
    mask and one mask a name of ``eval_ranges``, which maps a name such
    as "val" or "test" to a (range, mask) pair), ``sg``, and ``meta``, the
    scalars every rank shares (with ``perm``, the global id -> padded
    slot map under balance="edge", else None). ``rank_record`` takes one
    vertex block's part; ``shard_io.write_trainer_shards`` writes each."""
    begin, end, _count = train_range
    nv, nv_total = sg.nv, sg.padded_nv
    idx = np.arange(nv)

    def _valid(rng_, mask):
        b, e, _ = rng_
        v = (idx >= b) & (idx < e)          # GLOBAL id ranges
        v = v & (np.asarray(mask)[:nv] != 0)
        return pad_rows(v, nv_total, sg.perm)

    valid = _valid(train_range, train_mask)
    perm = (None if sg.perm is None
            or np.array_equal(sg.perm, np.arange(nv)) else sg.perm)
    meta = dict(cfg=dataclasses.asdict(cfg), nv=nv, nv_pad=sg.nv_pad,
                num_shards=sg.num_shards, begin=begin, end=end,
                count=max(int(valid.sum()), 1), use_ell=use_ell,
                overlap=overlap, perm=perm)
    return dict(
        sg=sg, meta=meta, valid=valid,
        x=pad_rows(np.asarray(feats, np.float32), nv_total, sg.perm),
        lab=pad_rows(np.asarray(labels).astype(np.int64), nv_total, sg.perm),
        eval_masks={k: _valid(rng_, m)
                    for k, (rng_, m) in (eval_ranges or {}).items()})


def rank_record(host: dict, g: int) -> dict:
    """Vertex block ``g``'s part of ``prepare_trainer_host``'s result:
    its ``RankShard`` and its rows."""
    nv_pad = host["meta"]["nv_pad"]
    rows = slice(g * nv_pad, (g + 1) * nv_pad)
    return dict(shard=host["sg"].shard(g), x=host["x"][rows],
                lab=host["lab"][rows], valid=host["valid"][rows],
                eval_masks={k: v[rows] for k, v in host["eval_masks"].items()})


def trainer_from_rank(cfg: ModelConfig, rec: dict, meta: dict, *,
                      graph_group=None, model_group=None, grad_group=None,
                      device="cpu") -> ShardedTrainer:
    """The rank's trainer from its record (``rank_record``, or a shard
    file) and the shared ``meta``; the one path of the in-memory and the
    file-built trainers. ``graph_group`` holds one rank a vertex block
    (the halo exchange, the logits' gather, the accuracy's counts);
    ``model_group`` the ranks that split this block's features (None:
    the 1-D trainer); ``grad_group`` every rank, over which the gradients
    are summed. The rank ships only its rows, its halo plan and the
    tables it consumes: the own/halo split for static weights with
    ``overlap``, else the unified table (GAT's, with its transpose and no
    packed weights); none on the plain route, which keeps the slot arrays
    instead."""
    shard = rec["shard"]
    if shard.num_shards != dist.get_world_size(graph_group):
        raise ValueError(f"{shard.num_shards} vertex blocks for a graph "
                         f"group of {dist.get_world_size(graph_group)} ranks")
    if shard.rank != dist.get_rank(graph_group):
        raise ValueError(f"vertex block {shard.rank}'s record on graph "
                         f"rank {dist.get_rank(graph_group)}")
    device = torch.device(device)
    begin, end, count = meta["begin"], meta["end"], meta["count"]
    use_ell = meta["use_ell"]
    packed = use_ell and cfg.arch != "gat"
    parts = (("own", "halo") if packed and meta["overlap"]
             else ("all",) if use_ell else ())
    ga = rank_graph_arrays(shard, plain=not use_ell, device=device)
    ell = build_rank_tables(shard, parts, packed=packed, device=device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    lab, valid = put(rec["lab"]), put(rec["valid"])
    eval_masks = {k: put(v) for k, v in rec["eval_masks"].items()}
    perm = None if meta["perm"] is None else put(meta["perm"])
    classes = torch.arange(cfg.num_cls, device=device)
    nv_pad = shard.nv_pad
    if model_group is None:
        m_n, m_i = 1, 0
        x = put(rec["x"])

        def forward(params):
            return _local_gconv_forward(cfg, params, ga, x, group=graph_group,
                                        ell=ell)
    else:
        m_n, m_i = dist.get_world_size(model_group), dist.get_rank(model_group)
        # only this rank's column block reaches the device
        x = column_block(torch.from_numpy(rec["x"]), m_i, m_n).to(device)

        def forward(params):
            return _local_gconv_forward_tp(cfg, params, ga, x,
                                           graph_group=graph_group,
                                           model_group=model_group, ell=ell)

    def train_step(params, opt):
        opt.zero_grad()
        logits = forward(params)
        probs = torch.softmax(logits, dim=-1)
        # a label outside [0, classes) has an all-zero row, as one_hot gives it
        onehot = (lab[:, None] == classes).to(logits.dtype)
        ce = gmath.cross_entropy(onehot, probs)
        local = torch.where(valid, ce, torch.zeros_like(ce)).sum()
        # this rank's own rows' loss, once (the model ranks of a block
        # each back-propagate it through their own column block);
        # reference gradient scaling: / (end - begin)
        (local / max(end - begin, 1)).backward()
        # one sum over every rank for every gradient, which assembles the
        # model ranks' distinct blocks, and for the loss, which only the
        # first rank of each model group adds
        ps = list(params.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps]
                         + [local.detach().reshape(1) * (m_i == 0)])
        flat = all_reduce_sum(flat, grad_group)
        off = 0
        for p in ps:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        opt.step()
        return flat[-1] / count

    @torch.no_grad()
    def eval_logits(params):
        rows = all_gather_rows(forward(params), graph_group)
        return rows[perm] if perm is not None else rows[:meta["nv"]]

    @torch.no_grad()
    def eval_accuracy(params, which: str = "val") -> float:
        vmask = eval_masks[which]
        pred = forward(params).argmax(-1)
        counts = torch.stack([(vmask & (pred == lab)).sum(), vmask.sum()])
        c, t = all_reduce_sum(counts, graph_group).tolist()
        return float(c) / max(float(t), 1.0)

    # a layer's activation width, a column block's under TP
    probe_x = x[:, :min(-(-cfg.dim_hid // m_n), x.shape[1])].contiguous()

    @torch.no_grad()
    def halo_probe() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        # float() waits for the device
        float(halo_exchange(probe_x, ga["send_idx"], ga["halo_map"],
                            graph_group).sum())
        return time.perf_counter() - t0

    return ShardedTrainer(
        mesh=grad_group, train_step=train_step, eval_logits=eval_logits,
        nv=meta["nv"], halo_probe=halo_probe, eval_accuracy=eval_accuracy,
        transport=transport(graph_group, device))


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
    """This process's rank of the 1-D trainer over ``sg``, whose shard
    count must be the group's size. ``device`` is the rank's device;
    ``eval_ranges`` as ``prepare_trainer_host`` takes it."""
    if sg.num_shards != dist.get_world_size(group):
        raise ValueError(f"{sg.num_shards} shards for a group of "
                         f"{dist.get_world_size(group)} ranks")
    host = prepare_trainer_host(cfg, sg, feats, labels, train_range,
                                train_mask, use_ell=use_ell, overlap=overlap,
                                eval_ranges=eval_ranges)
    return trainer_from_rank(cfg, rank_record(host, dist.get_rank(group)),
                             host["meta"], graph_group=group,
                             grad_group=group, device=device)


def check_tp_config(cfg: ModelConfig) -> None:
    """ValueError unless tensor parallelism covers ``cfg``: GCN, SAGE or
    GAT, GAT with the dense head (its gconv output stays column-blocked;
    the reference's GAT config always has it, net.cpp:447). GGNN's GRU
    state would have to go whole and replicated before the classifier."""
    if cfg.arch not in ("gcn", "sage", "gat"):
        raise ValueError(f"tensor parallelism covers gcn, sage and gat, "
                         f"not {cfg.arch}")
    if cfg.arch == "gat" and not cfg.use_dense:
        raise ValueError("tensor-parallel GAT needs use_dense (its gconv "
                         "output stays column-blocked)")


def make_tp_trainer(
    cfg: ModelConfig,
    sg: ShardedGraph,
    feats: np.ndarray,
    labels: np.ndarray,
    train_range: tuple[int, int, int],
    train_mask: np.ndarray,
    *,
    model_parallelism: int,
    group=None,
    device="cpu",
    use_ell: bool = True,
    overlap: bool = True,
    eval_ranges: dict | None = None,
) -> ShardedTrainer:
    """This process's rank of the tensor-parallel trainer: ``group``'s
    ranks (the default group's by default) as a (G graph x M model) grid,
    M = ``model_parallelism`` (``multihost.hybrid_groups``); ``sg`` must
    be built for the G vertex blocks. Ragged feature widths zero-pad per
    ``tp.tp_matmul``. Collective over ``group``, which creates the
    subgroups."""
    check_tp_config(cfg)
    graph_group, model_group, g = hybrid_groups(model_parallelism, group)
    n = dist.get_world_size(group)
    if sg.num_shards != n // model_parallelism:
        raise ValueError(f"{sg.num_shards} vertex blocks: build the sharded "
                         f"graph for the {n // model_parallelism} graph "
                         f"blocks, not for {n} ranks")
    host = prepare_trainer_host(cfg, sg, feats, labels, train_range,
                                train_mask, use_ell=use_ell, overlap=overlap,
                                eval_ranges=eval_ranges)
    return trainer_from_rank(cfg, rank_record(host, g), host["meta"],
                             graph_group=graph_group, model_group=model_group,
                             grad_group=group, device=device)
