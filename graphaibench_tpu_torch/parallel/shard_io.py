"""Per-rank shard files for the sharded trainers.

Counterpart of ``graphaibench_tpu/parallel/shard_io.py``, the reference's
offline-partition flow (graph_partition.cc:18-35, each rank reading only
its own file, multigpu_nvshmem.cu:13-120) for the trainers:
``write_trainer_shards`` does the host preparation once and writes one
``<prefix>-shard<g>.pkl`` a vertex block; ``make_sharded_trainer_from_files``
has each rank read only its block's file and build its tables from it,
never from a global graph. Under tensor parallelism the M model ranks of
a block read the same file.

The files are the port's own format, not the JAX package's, whose pickles
hold objects of that package (its stacked ELL layouts). A file holds
plain numpy arrays and Python scalars: the block's rows of the features,
labels, training mask and evaluation masks; its ``RankShard`` (the slice
of the ``ShardedGraph`` its tables and halo plan are built from) as a
dict; and ``meta``, which every file of one write shares: ``format``,
``write_id``, ``cfg`` as a dict, ``nv``, ``nv_pad``, ``num_shards``,
``begin``, ``end``, ``count``, ``use_ell``, ``overlap`` and ``perm`` (the
global id -> padded slot map under balance="edge", else None; JAX's files
drop it, so their ``eval_logits`` come back in shard order).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import torch.distributed as dist

from graphaibench_tpu_torch.nn.layers import ModelConfig
from graphaibench_tpu_torch.parallel.multihost import hybrid_groups
from graphaibench_tpu_torch.parallel.partition import RankShard
from graphaibench_tpu_torch.parallel.train import (
    ShardedTrainer,
    check_tp_config,
    prepare_trainer_host,
    rank_record,
    trainer_from_rank,
)

_FORMAT = 1


def _shard_path(prefix: str, g: int) -> str:
    return f"{prefix}-shard{g}.pkl"


def write_trainer_shards(prefix: str, cfg: ModelConfig, sg, feats, labels,
                         train_range, train_mask, *, use_ell: bool = True,
                         overlap: bool = True,
                         eval_ranges: dict | None = None) -> None:
    """Prepare the trainer's host state (``train.prepare_trainer_host``)
    and write one file a vertex block of ``sg``; each is written under a
    temporary name and moved into place."""
    host = prepare_trainer_host(cfg, sg, feats, labels, train_range,
                                train_mask, use_ell=use_ell, overlap=overlap,
                                eval_ranges=eval_ranges)
    # a nonce per write: a loader detects files of two writes mixed (an
    # interrupted rewrite of a prefix would otherwise splice old and new
    # shards of one shape)
    meta = dict(host["meta"], format=_FORMAT, write_id=os.urandom(8).hex())
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    for g in range(sg.num_shards):
        rec = rank_record(host, g)
        rec["shard"] = dataclasses.asdict(rec["shard"])
        rec["meta"] = meta
        tmp = _shard_path(prefix, g) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(rec, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, _shard_path(prefix, g))


def load_local_shards(prefix: str, shard_ids: list[int]) -> tuple[list, dict]:
    """The records of the listed vertex blocks, each with its
    ``RankShard``, and their shared ``meta``. Raises ValueError on
    another format or on files of two writes."""
    recs = []
    for g in shard_ids:
        with open(_shard_path(prefix, g), "rb") as f:
            recs.append(pickle.load(f))
    meta = recs[0]["meta"]
    if meta.get("format") != _FORMAT:
        raise ValueError(f"unsupported shard-file format {meta.get('format')}"
                         f" (this reader takes {_FORMAT})")
    for g, r in zip(shard_ids, recs):
        if r["meta"]["write_id"] != meta["write_id"]:
            raise ValueError(
                f"shard {g} is from another write (write_id "
                f"{r['meta']['write_id']} != {meta['write_id']}): rewrite "
                f"the prefix")
        r["shard"] = RankShard(**r["shard"])
        del r["meta"]
    return recs, meta


def make_sharded_trainer_from_files(
    prefix: str,
    *,
    group=None,
    model_parallelism: int = 1,
    device="cpu",
) -> tuple[ShardedTrainer, ModelConfig]:
    """This rank's trainer built from its vertex block's file alone: the
    1-D trainer over ``group``'s ranks, or with ``model_parallelism`` M >
    1 the tensor-parallel one on a (G graph x M model) grid, the files
    written for G blocks. Collective over ``group``; every rank checks
    that all ranks read files of one write. Returns (trainer, cfg)."""
    if model_parallelism > 1:
        graph_group, model_group, g = hybrid_groups(model_parallelism, group)
    else:
        graph_group, model_group, g = group, None, dist.get_rank(group)
    (rec,), meta = load_local_shards(prefix, [g])
    ids = [None] * dist.get_world_size(group)
    dist.all_gather_object(ids, (meta["format"], meta["write_id"]),
                           group=group)
    if len(set(ids)) != 1:
        raise ValueError(f"the ranks read files of {len(set(ids))} writes "
                         f"of {prefix}: rewrite the prefix")
    cfg = ModelConfig(**meta["cfg"])
    if model_group is not None:
        check_tp_config(cfg)
    trainer = trainer_from_rank(cfg, rec, meta, graph_group=graph_group,
                                model_group=model_group, grad_group=group,
                                device=device)
    return trainer, cfg
