"""Products-shaped full-batch GNN epochs of the PyTorch port, one card.

The JAX tool ``tools/products_bench.py`` defines the shape: ogbn-products is
not downloaded, so a synthetic graph of its shape stands in for it,
``rmat(21, 26, seed=0)`` symmetrised (2,097,152 vertices, about 103 M
directed edges; cached in ``.rmat_cache/``), feat 100, 47 classes, 2 layers
of 128. Degree structure is rmat's, not the Amazon co-purchase graph's: the
numbers are "products-shaped", never the real dataset's.

For each of GCN, SAGE, GAT and GGNN, with ``cfg.remat`` off and on: the
epoch's (one full-batch step: forward, backward, Adam) host seconds (median
of ``--epochs`` after one warm epoch, each ending when its loss reaches the
host), its device ms (the kernels' summed time under torch.profiler over
``--epochs`` epochs, a mean; null on the CPU), and the memory: the
allocator's peak during the model's set-up, what the model holds after it,
and the peak during the epochs (everything held included). Then GCN on
the 1-D sharded trainer at one rank (``parallel/``, an nccl group of one on
the card, gloo on the CPU) beside it. Each section is guarded: an out-of-
memory error is recorded with the bytes it asked for, and the next section
still runs. Prints a line per section and, last, one JSON object.

    python3 tools/products_bench_torch.py [--device cuda|cpu] [--scale 21]
        [--ef 26] [--epochs 3] [--archs gcn,sage,gat,ggnn]

``PRODUCTS_SCALE``, ``PRODUCTS_EF``, ``PRODUCTS_EPOCHS`` and
``PRODUCTS_ARCHS`` give the defaults, as for the JAX tool. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FEAT, CLASSES, HIDDEN = 100, 47, 128


def card_line(device: str) -> str | None:
    """nvidia-smi's name and power limit of the card, or None on the CPU."""
    if device != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def products_dataset(scale: int, ef: int, *, train_share: float = 1.0,
                     val_share: float = 0.0):
    """The products-shaped graph and its dataset: normal features from seed
    0, uniform labels, the first ``train_share`` of the vertices training,
    the next ``val_share`` validation, the rest test (with no split after
    training, every vertex in all three, as the JAX tool has it)."""
    from graphaibench_tpu_torch import GnnDataset
    from graphaibench_tpu_torch.graph.generators import rmat

    t0 = time.perf_counter()
    g = rmat(scale, ef, seed=0)
    build_s = time.perf_counter() - t0
    nv = g.nv
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((nv, FEAT)).astype(np.float32)
    labels = rng.integers(0, CLASSES, nv).astype(np.int32)
    mask = np.ones(nv, dtype=np.uint8)
    if train_share >= 1.0:
        tr = va = te = (0, nv, nv)
    else:
        n_tr, n_val = int(nv * train_share), int(nv * val_share)
        tr = (0, n_tr, n_tr)
        va = (n_tr, n_tr + n_val, n_val)
        te = (n_tr + n_val, nv, nv - n_tr - n_val)
    ds = GnnDataset(graph=g, feats=feats, labels=labels, train_mask=mask,
                    val_mask=mask, test_mask=mask, num_classes=CLASSES,
                    train_range=tr, val_range=va, test_range=te)
    return ds, build_s


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device: str) -> float | None:
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def held_gib(device: str) -> float | None:
    return torch.cuda.memory_allocated() / 2**30 if device == "cuda" else None


def set_up_memory(device: str) -> dict:
    """The set-up's peak and what it left held, the peak reset for what
    follows."""
    rec = {"setup_peak_gib": peak_gib(device), "held_gib": held_gib(device)}
    reset_peak(device)
    return rec


def device_ms(step, n: int, device: str) -> float | None:
    """The kernels' summed device time of one call of ``step`` under
    torch.profiler, the mean of ``n`` calls; None on the CPU or where the
    trace holds no device event."""
    if device != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / n / 1e3 if us > 0 else None


def oom_record(e: BaseException) -> dict:
    """What an out-of-memory error asked for: its message and, where the
    allocator names it, the size of the allocation that failed."""
    msg = f"{type(e).__name__}: {e}"
    rec = {"error": msg[:400]}
    m = re.search(r"Tried to allocate ([0-9.]+) (GiB|MiB|KiB|B)", msg)
    if m:
        scale = {"GiB": 2**30, "MiB": 2**20, "KiB": 2**10, "B": 1}[m.group(2)]
        rec["asked_bytes"] = int(float(m.group(1)) * scale)
    return rec


def bench_model(ds, arch: str, remat: bool, epochs: int, device: str) -> dict:
    from graphaibench_tpu_torch.nn import Model
    from graphaibench_tpu_torch.nn.layers import ModelConfig

    # the JAX tool's ModelConfig: 2 gconv layers for every arch, no head
    cfg = ModelConfig(arch=arch, num_layers=2, dim_init=FEAT, dim_hid=HIDDEN,
                      num_cls=CLASSES, lr=0.01, remat=remat)
    reset_peak(device)
    t0 = time.perf_counter()
    m = Model(cfg, ds, device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    try:
        memory = set_up_memory(device)
        m.train(1, verbose=False)                   # warm
        log = m.train(epochs, verbose=False)
        rec = {"setup_s": setup_s, **memory,
               "epoch_peak_gib": peak_gib(device),
               "epoch_host_s": statistics.median(dt for _, _, dt in log),
               "epoch_host_s_all": [dt for _, _, dt in log],
               "losses": [l for l, _, _ in log],
               "epoch_device_ms": device_ms(m.train_epoch, epochs, device)}
    finally:
        del m
    return rec


def bench_sharded(ds, epochs: int, device: str) -> dict:
    """GCN 2 x 128 on the 1-D sharded trainer at one rank: an nccl group of
    one in this process on the card, gloo on the CPU."""
    from graphaibench_tpu_torch import parallel as PAR
    from graphaibench_tpu_torch.nn.layers import ModelConfig, init_params
    from graphaibench_tpu_torch.nn.model import (
        aggregation_weights,
        prepare_graph,
    )
    from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
    from graphaibench_tpu_torch.parallel.multihost import free_port

    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=FEAT,
                      dim_hid=HIDDEN, num_cls=CLASSES, lr=0.01)
    PAR.initialize(0, 1, port=free_port(),
                   backend="nccl" if device == "cuda" else "gloo",
                   device=torch.device(device, 0) if device == "cuda" else None)
    try:
        reset_peak(device)
        t0 = time.perf_counter()
        gp = prepare_graph(ds.graph, "gcn")
        sg = PAR.build_sharded_graph(gp, aggregation_weights(gp, "gcn"), 1)
        trainer = PAR.make_sharded_trainer(cfg, sg, ds.feats, ds.labels,
                                           ds.train_range, ds.train_mask,
                                           device=device)
        params = init_params(cfg, device=device)
        opt = OPTIMIZERS[cfg.optimizer](params.parameters(), lr=cfg.lr)
        _sync(device)
        setup_s = time.perf_counter() - t0
        memory = set_up_memory(device)
        trainer.train_step(params, opt)             # warm
        times, losses = [], []
        for _ in range(epochs):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(params, opt)))
            times.append(time.perf_counter() - t0)
        return {"setup_s": setup_s, **memory,
                "epoch_peak_gib": peak_gib(device),
                "epoch_host_s": statistics.median(times),
                "epoch_host_s_all": times, "losses": losses,
                "epoch_device_ms": device_ms(
                    lambda: trainer.train_step(params, opt), epochs, device),
                "transport": trainer.transport}
    finally:
        PAR.multihost.dist.destroy_process_group()


def _section(results: dict, key: str, fn) -> None:
    """Run one section; an error, out-of-memory included, is recorded under
    ``key`` and the next section runs."""
    try:
        results[key] = fn()
    except Exception as e:  # noqa: BLE001 - every section is guarded
        results[key] = oom_record(e)
    finally:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    print(f"  {key}: {json.dumps(results[key])}", flush=True)


def main(argv=None) -> int:
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=int, default=int(env("PRODUCTS_SCALE", "21")))
    ap.add_argument("--ef", type=int, default=int(env("PRODUCTS_EF", "26")))
    ap.add_argument("--epochs", type=int,
                    default=int(env("PRODUCTS_EPOCHS", "3")))
    ap.add_argument("--archs", default=env("PRODUCTS_ARCHS",
                                           "gcn,sage,gat,ggnn"))
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the sharded trainer at one rank")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (--device=cpu runs on the CPU)", file=sys.stderr)
        return 1
    card = card_line(args.device)
    if card:
        print(card, flush=True)
    ds, build_s = products_dataset(args.scale, args.ef)
    print(f"products-shaped graph: |V| {ds.graph.nv} |E| {ds.graph.ne} "
          f"(build {build_s:.1f} s)", flush=True)
    results = {"nv": ds.graph.nv, "ne": ds.graph.ne, "graph_build_s": build_s}
    for arch in args.archs.split(","):
        for remat in (False, True):
            _section(results, f"{arch}{'_remat' if remat else ''}",
                     lambda a=arch, r=remat: bench_model(ds, a, r, args.epochs,
                                                         args.device))
    if not args.no_sharded:
        _section(results, "gcn_sharded_p1",
                 lambda: bench_sharded(ds, args.epochs, args.device))
    print(json.dumps({
        "metric": "products_shaped_epoch", "device": args.device,
        "card": card,
        "config": f"rmat{args.scale} ef{args.ef} symmetrized, feat {FEAT}, "
                  f"{CLASSES} classes, 2x{HIDDEN} layers",
        **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
