"""Data-parallel GraphSAINT: n sampled subgraphs per optimizer step.

Counterpart of ``graphaibench_tpu/parallel/dp_saint.py``. The reference
pre-samples ``num_subgraphs = num_threads`` subgraphs in an OMP-parallel
loop (net.cpp:159, 288-358); here, as in the JAX package, each of n
ranks trains on its own subgraph and the gradients are averaged: one
step is a GraphSAINT minibatch of n subgraphs. One process per rank, as
the sharded trainer has; each holds a ``Model`` built from the same seed,
so the parameters start equal, and every rank applies the same averaged
gradients, so they stay equal.

At step ``it`` rank r samples and pads its subgraph with seed ``seed + it
n + r`` (the JAX package's arithmetic), in a one-thread pool that
prepares step it + 1's while step it runs, as ``Model.train_sampled``
does. A rank pads its edges to its own ``e_pad``: the JAX package stacks
the n subgraphs on one shape (``_stack_batch``) because ``shard_map``
needs it; pads add zeros, so the step's result is the same.
"""

from __future__ import annotations

import concurrent.futures
import time

import torch
import torch.distributed as dist

from graphaibench_tpu_torch.parallel.halo import all_reduce_sum
from graphaibench_tpu_torch.utils import timers as timers_mod


def make_dp_saint_step(model, group=None):
    """step(d) -> (loss, acc) for this rank's padded subgraph ``d``: the
    rank's forward and backward (``Model._sampled_backward``), one sum
    over ``group`` of the gradients, the loss and the accuracy's counts,
    the gradients and the loss divided by the ranks' number, then the
    optimizer's step on every rank. The loss is the mean of the ranks'
    losses (each the sum of CE / its subgraph's real vertices); the
    accuracy the summed correct over the summed valid vertices. Both are
    device scalars from the forward pass before the update."""
    n = dist.get_world_size(group)
    ps = list(model.params.parameters())

    def step(d: dict):
        loss, logits, lab, valid = model._sampled_backward(d)
        with torch.no_grad():
            hits = (valid & (logits.argmax(-1) == lab)).sum()
            counts = torch.stack([loss, hits.to(loss.dtype),
                                  valid.sum().to(loss.dtype)])
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps]
                         + [counts])
        flat = all_reduce_sum(flat, group)
        off = 0
        for p in ps:
            p.grad = flat[off:off + p.numel()].view_as(p) / n
            off += p.numel()
        model.opt.step()
        loss_sum, correct, total = flat[off:]
        return loss_sum / n, correct / torch.clamp(total, min=1.0)

    return step


def train_sampled_dp(model, num_steps: int, subg_size: int, *, group=None,
                     val_interval: int = 50, verbose: bool = True,
                     seed: int = 0) -> list[tuple[float, float, float]]:
    """``num_steps`` data-parallel GraphSAINT steps on this rank's
    ``model`` (an ``nn.Model``; collective over ``group``, every rank
    calls it with its own). Rank 0 prints the JAX package's lines when
    ``verbose``: ``Step ... subg_nv [...] train_loss ... train_acc ...``
    (with ``val_acc`` every ``val_interval`` steps) ``time ... s``, then
    the average time per step. The model's ``timers``, if any, get the
    sampler's wait (``sample``) and the step (``step``). Returns (loss,
    acc, seconds) per step, as ``Model.train_sampled`` does."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    say = verbose and rank == 0
    timers = model.timers
    prepare, e_pad = model._subgraph_source(subg_size)
    step = make_dp_saint_step(model, group)
    log = []
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        fut = pool.submit(prepare, seed + rank, e_pad)
        for it in range(num_steps):
            t0 = time.perf_counter()
            d = fut.result()
            if timers is not None:
                timers.add(timers_mod.OP_SAMPLE, time.perf_counter() - t0)
            e_pad = d["e_pad"]
            if it + 1 < num_steps:   # double-buffer the sampler
                fut = pool.submit(prepare, seed + (it + 1) * n + rank, e_pad)
            t_step = time.perf_counter()
            loss, acc = step(d)
            loss, acc = float(loss), float(acc)   # waits for the device
            if timers is not None:
                timers.add(timers_mod.OP_STEP, time.perf_counter() - t_step)
            if verbose:   # every rank's subgraph size, for rank 0's line
                sizes = [None] * n
                dist.all_gather_object(sizes, d["n_real"], group=group)
            dt = time.perf_counter() - t0
            log.append((loss, acc, dt))
            if say:
                line = (f"Step {it:3d} subg_nv {sizes} "
                        f"train_loss {loss:.3f} train_acc {acc:.3f}")
                if it % val_interval == 0 and it != 0:
                    line += f" val_acc {model.evaluate('val'):.3f}"
                print(f"{line} time {dt:.4f} s", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    if say and num_steps:
        total = sum(dt for _, _, dt in log)
        print(f"Average time per DP step ({n} subgraphs): "
              f"{total / num_steps:.5f} seconds.", flush=True)
    return log
