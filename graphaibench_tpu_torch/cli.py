"""Command-line entry point of the port.

``python -m graphaibench_tpu_torch.cli train gcn|sage|gat|ggnn <dataset>
[epochs threads loss hidden score_drop feat_drop lr layers subg_size
val_interval inductive] [--timers] [--profile=DIR] [--device=cuda|cpu]``
takes the argv of ``graphaibench_tpu.cli train`` (the reference trainer's,
train.cpp:9-14) plus ``--device`` (default ``cuda``; there is no fallback
to the CPU when no card is found). It runs everything the JAX CLI runs on
one device: full-batch training, inductive training (``inductive=1``),
GraphSAINT-sampled training (``subg_size > 0``, which turns ``inductive``
on), ``--timers`` (the stage time breakdown after training, train.cpp:60-76)
and ``--profile=DIR`` (a torch.profiler Chrome trace of the whole run in
``DIR/trace.json``). ``GAB_SHARDS=<n|auto>`` routes full-batch training
(and the analytics, below) onto the sharded trainer (``parallel/``): n
ranks, spawned on this host, each holding one vertex block and exchanging
its halo over ``torch.distributed`` (nccl where each rank has a card of
its own, gloo on the CPU and where ranks share a card); ``auto`` is one rank per
visible card, or one rank with ``--device=cpu``. ``GAB_TP=m`` beside it
lays max(n // m, 1) x m ranks out as a (graph x model) grid and splits
the feature dimension over the m ranks of each vertex block (the
tensor-parallel trainer; GCN, SAGE, and GAT with its dense head: GGNN
exits with code 2). ``GAB_DP=p`` with ``subg_size > 0`` trains each step
on p sampled subgraphs, one a rank, the gradients averaged
(data-parallel GraphSAINT). The ranks take their backend as
``GAB_SHARDS`` does; rank 0 prints the JAX CLI's lines.

``python -m graphaibench_tpu_torch.cli partition <dataset> <num_parts>
<out-prefix>`` writes the JAX CLI's induced partitions (``<prefix>-part<i>``
directories, byte-equal), on the host.

``python -m graphaibench_tpu_torch.cli analytics
tc|bfs|sssp|pr|cc|bc|kcore <dataset> [source] [--device=cuda|cpu]`` runs the
JAX CLI's ``analytics`` route for those solvers (``analytics.run_benchmark``),
with the same default device and no fallback; a compressed-graph prefix
decodes on that device (``GAB_TC_STREAM=1`` counts triangles off a CGR
stream); ``GAB_SHARDS=<n|auto>`` runs the distributed solvers
(``parallel/dist_analytics.py``) on n ranks counted as for training, rank
0 printing the JAX CLI's lines (``cc``, ``bc`` and ``kcore`` on a directed
graph run single-device, as in the JAX CLI); the other analytics kernels
exit with code 2 and name their ROADMAP item.

``python -m graphaibench_tpu_torch.cli info <dataset>`` prints the JAX
CLI's ``info`` lines (sizes, degrees, labels, mask ranges, a pow2 degree
histogram) on the host; for a compressed-graph prefix, decoded on the host,
its sizes and degrees.

``python -m graphaibench_tpu_torch.cli compress
compress|decompress|verify|info ...`` is the JAX CLI's ``compress`` route
(``compress/cli.py``: the four schemes, ``-p`` byte permutation), on the
host.

Dataset resolution: an existing directory (or compressed-graph prefix) is
used directly; otherwise ``$DATASET_PATH/<name>`` (configs.h:5).
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys

USAGE = ("usage: train gcn|sage|gat|ggnn <dataset> [epochs=10] [threads=0] [loss=softmax] "
         "[hidden=16] [score_drop=0] [feat_drop=0] [lr=0.02] [layers=2] "
         "[subg_size=0] [val_interval=50] [inductive=0] [--timers] "
         "[--profile=DIR] [--device=cuda|cpu]")


def resolve_dataset(name: str) -> str:
    if os.path.isdir(name):
        return name
    if os.path.exists(name + ".meta.json"):  # compressed-graph prefix
        return name
    root = os.environ.get("DATASET_PATH")
    if root and os.path.isdir(os.path.join(root, name)):
        return os.path.join(root, name)
    raise SystemExit(f"dataset '{name}' not found (set DATASET_PATH)")


ANALYTICS_USAGE = ("usage: analytics tc|bfs|sssp|pr|cc|bc|kcore <dataset> "
                   "[source=0] [--device=cuda|cpu] (GAB_SHARDS=<n|auto> "
                   "runs it on n ranks)")


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def cmd_train(argv: list[str]) -> int:
    device = "cuda"
    use_timers = False
    profile_dir = None
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a == "--timers":
            use_timers = True
        elif a.startswith("--profile="):
            profile_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    argv = rest
    if len(argv) < 2:
        print(USAGE)
        return 2
    if device not in ("cuda", "cpu"):
        return _refuse(f"--device must be cuda or cpu, not {device!r}")
    arch = argv[0]
    if arch not in ("gcn", "sage", "gat", "ggnn"):
        return _refuse(f"unknown arch {arch!r}: one of gcn, sage, gat, ggnn")

    def arg(i, default, cast):
        return cast(argv[i]) if len(argv) > i else default

    epochs = arg(2, 10, int)
    _threads = arg(3, 0, int)  # accepted for argv parity
    loss = arg(4, "softmax", str)
    hidden = arg(5, 16, int)
    score_drop = arg(6, 0.0, float)
    feat_drop = arg(7, 0.0, float)
    lr = arg(8, 0.02, float)
    layers = arg(9, 2, int)
    subg_size = arg(10, 0, int)
    val_interval = arg(11, 50, int)
    inductive = bool(arg(12, 0, int)) or subg_size > 0
    # as in the JAX CLI, GAB_SHARDS routes full-batch training only, and
    # GAB_DP sampled training only
    shards = os.environ.get("GAB_SHARDS", "")
    sharded = bool(shards) and subg_size == 0 and not inductive
    tp = int(os.environ.get("GAB_TP", "1")) if sharded else 1
    dp = int(os.environ.get("GAB_DP", "1")) if subg_size > 0 else 1

    path = resolve_dataset(argv[1])
    if os.path.exists(path + ".meta.json"):
        return _refuse("train does not accept compressed-graph prefixes; "
                       "decompress first")
    from graphaibench_tpu_torch.nn import Model, make_config
    from graphaibench_tpu_torch.utils.timers import TIMERS, profiler_trace

    is_sigmoid = loss == "sigmoid"
    ds = _load_dataset(path, is_sigmoid)
    cfg = make_config(
        arch, layers, ds.feat_len, hidden, ds.num_classes,
        subg_size=subg_size, feat_drop=feat_drop, score_drop=score_drop,
        lr=lr, is_sigmoid=is_sigmoid,
    )
    print(
        f"num_vertices = {ds.graph.nv}, num_edges = {ds.graph.ne}, "
        f"num_layers = {cfg.num_layers},\nnum_epochs = {epochs}, "
        f"input_length = {ds.feat_len}, hidden_length = {hidden}, "
        f"num_classes = {ds.num_classes},\nfeat_drop = {feat_drop}, "
        f"score_drop = {score_drop}, subg_size = {subg_size}, "
        f"val_interval = {val_interval}, learning_rate = {lr}, "
        f"device = {device}"
    )
    if tp > 1:
        from graphaibench_tpu_torch.parallel.train import check_tp_config

        try:   # the JAX CLI asserts here
            check_tp_config(cfg)
        except ValueError as e:
            return _refuse(f"GAB_TP: {e}")
    if sharded or dp > 1:
        return _train_ranks(cfg, path, epochs, val_interval,
                            shards if sharded else "", tp, dp, subg_size,
                            device, use_timers, profile_dir)
    timers = TIMERS if use_timers else None
    if timers is not None:
        timers.reset()
    prof = profiler_trace(profile_dir) if profile_dir else contextlib.nullcontext()
    with prof:
        model = Model(cfg, ds, device=device, inductive=inductive,
                      timers=timers)
        if subg_size > 0:
            model.train_sampled(epochs, subg_size, val_interval=val_interval)
        else:
            model.train(epochs, val_interval=val_interval)
        print(f"Test accuracy: {model.evaluate('test'):.4f}")
    if timers is not None:
        timers.print_timers()
    return 0


def _load_dataset(path: str, is_sigmoid: bool):
    from graphaibench_tpu_torch.graph.io import (
        load_gnn_dataset,
        load_gnn_dataset_csgr,
    )

    if glob.glob(os.path.join(path, "*.csgr")):
        return load_gnn_dataset_csgr(path, is_single_class=not is_sigmoid)
    return load_gnn_dataset(path, is_single_class=not is_sigmoid)


def _train_ranks(cfg, path: str, epochs: int, val_interval: int,
                 shards: str, tp: int, dp: int, subg_size: int, device: str,
                 use_timers: bool, profile_dir) -> int:
    """Training in ranks spawned here, rank 0 printing: with ``GAB_SHARDS``
    the sharded trainer (``parallel/train.py``) on n ranks, or with
    ``GAB_TP`` = m > 1 the tensor-parallel one on max(n // m, 1) x m
    ranks; else data-parallel GraphSAINT (``parallel/dp_saint.py``) on
    ``GAB_DP`` ranks."""
    import torch

    from graphaibench_tpu_torch.parallel.multihost import count_ranks, launch

    route = "GAB_SHARDS" if shards else "GAB_DP"
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{route}: no CUDA device (--device=cpu runs the ranks on "
              "the CPU)", file=sys.stderr)
        return 1
    try:
        n = count_ranks(shards, device) if shards else dp
    except ValueError as e:
        return _refuse(str(e))
    if tp > 1:
        n = max(n // tp, 1) * tp
    sys.stdout.flush()
    if shards:
        launch(_sharded_rank, n, cfg, path, epochs, val_interval, tp, device,
               use_timers, profile_dir, device=device, timeout_s=None)
    else:
        launch(_dp_rank, n, cfg, path, epochs, val_interval, subg_size,
               device, use_timers, profile_dir, device=device, timeout_s=None)
    return 0


def _dp_rank(rank: int, n: int, cfg, path: str, epochs: int,
             val_interval: int, subg_size: int, device: str,
             use_timers: bool, profile_dir) -> None:
    """One rank of ``GAB_DP``: the JAX CLI's data-parallel lines, printed
    by rank 0, then its model's test accuracy."""
    from graphaibench_tpu_torch.nn import Model
    from graphaibench_tpu_torch.parallel import train_sampled_dp
    from graphaibench_tpu_torch.parallel.multihost import rank_device
    from graphaibench_tpu_torch.utils.timers import TIMERS, profiler_trace

    timers = TIMERS if use_timers and rank == 0 else None
    if timers is not None:
        timers.reset()
    prof = (profiler_trace(profile_dir) if profile_dir and rank == 0
            else contextlib.nullcontext())
    with prof:
        model = Model(cfg, _load_dataset(path, cfg.is_sigmoid),
                      device=rank_device(rank, device), inductive=True,
                      timers=timers)
        train_sampled_dp(model, epochs, subg_size, val_interval=val_interval)
        if rank == 0:
            print(f"Test accuracy: {model.evaluate('test'):.4f}", flush=True)
    if timers is not None:
        timers.print_timers()


def _sharded_rank(rank: int, n: int, cfg, path: str, epochs: int,
                  val_interval: int, tp: int, device: str, use_timers: bool,
                  profile_dir) -> None:
    """One rank of ``GAB_SHARDS``: the JAX CLI's ``_train_sharded`` lines,
    printed by rank 0."""
    import time

    import torch
    import torch.distributed as dist

    from graphaibench_tpu_torch.nn.layers import init_params
    from graphaibench_tpu_torch.nn.model import (
        aggregation_weights,
        prepare_graph,
    )
    from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
    from graphaibench_tpu_torch.ops import math as gmath
    from graphaibench_tpu_torch.parallel import (
        build_sharded_graph,
        make_sharded_trainer,
        make_tp_trainer,
    )
    from graphaibench_tpu_torch.parallel.multihost import rank_device
    from graphaibench_tpu_torch.parallel.tp import REDUCE_SCATTER
    from graphaibench_tpu_torch.utils import timers as utimers
    from graphaibench_tpu_torch.utils.timers import TIMERS, profiler_trace

    def say(line: str) -> None:
        if rank == 0:
            print(line, flush=True)

    dev = rank_device(rank, device)
    ds = _load_dataset(path, cfg.is_sigmoid)
    prepped = prepare_graph(ds.graph, cfg.arch)
    w = aggregation_weights(prepped, cfg.arch)
    args = (ds.feats, ds.labels, ds.train_range, ds.train_mask)
    kw = dict(device=dev, eval_ranges={"val": (ds.val_range, ds.val_mask),
                                       "test": (ds.test_range, ds.test_mask)})
    if tp > 1:
        gdim = n // tp
        trainer = make_tp_trainer(cfg, build_sharded_graph(prepped, w, gdim),
                                  *args, model_parallelism=tp, **kw)
        say(f"sharded trainer: ({gdim} graph x {tp} model) ranks, vertex "
            f"sharding + feature-dim tensor parallelism, backend "
            f"{dist.get_backend()}, transport {trainer.transport}, "
            f"reduce-scatter {REDUCE_SCATTER}")
    else:
        trainer = make_sharded_trainer(
            cfg, build_sharded_graph(prepped, w, n), *args, **kw)
        say(f"sharded trainer: {n} rank(s), vertex-sharded halo exchange, "
            f"backend {dist.get_backend()}, halo transport "
            f"{trainer.transport}")
    params = init_params(cfg, device=dev)
    opt = OPTIMIZERS[cfg.optimizer](params.parameters(), lr=cfg.lr)
    timers = TIMERS if use_timers and rank == 0 else None
    if timers is not None:
        timers.reset()
    labels = torch.from_numpy(ds.labels).to(dev)

    def masked_acc(rng_, mask) -> float:
        logits = trainer.eval_logits(params)
        begin, end, _ = rng_
        idx = torch.arange(logits.shape[0], device=dev)
        valid = ((idx >= begin) & (idx < end)
                 & (torch.from_numpy(mask).to(dev) != 0))
        return float(gmath.masked_f1_micro(torch.sigmoid(logits), labels,
                                           valid))

    prof = (profiler_trace(profile_dir) if profile_dir and rank == 0
            else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        for epoch in range(epochs):
            ts = time.perf_counter()
            loss = float(trainer.train_step(params, opt))
            line = f"Epoch {epoch:3d}: train_loss = {loss:.4f}"
            if timers is not None:   # float(loss) above waited for the device
                timers.add(utimers.OP_STEP, time.perf_counter() - ts)
            if epoch % val_interval == 0 and epoch != 0:
                te = time.perf_counter()
                va = (masked_acc(ds.val_range, ds.val_mask) if cfg.is_sigmoid
                      else trainer.eval_accuracy(params, "val"))
                line += f" val_acc {va:.3f}"
                if timers is not None:
                    timers.add(utimers.OP_EVAL, time.perf_counter() - te)
            say(line)
        dt = time.perf_counter() - t0
        say(f"time per epoch: {dt / max(epochs, 1):.4f} s")
        te = time.perf_counter()
        acc = (masked_acc(ds.test_range, ds.test_mask) if cfg.is_sigmoid
               else trainer.eval_accuracy(params, "test"))
        if timers is not None:
            timers.add(utimers.OP_EVAL, time.perf_counter() - te)
        if use_timers:
            # the halo exchange alone (the step overlaps it with the own
            # rows' aggregation), after a warm-up; every rank takes part
            trainer.halo_probe()
            halo_s = trainer.halo_probe()
            if timers is not None:
                timers.add(utimers.OP_HALO, halo_s)
        say(f"Test accuracy: {acc:.4f}")
    if timers is not None:
        timers.print_timers()


def cmd_analytics(argv: list[str]) -> int:
    """<kernel> <dataset> [args...] — the analytics solvers with their
    verifiers, on ``--device`` (default ``cuda``)."""
    device = "cuda"
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if len(rest) < 2:
        print(ANALYTICS_USAGE)
        return 2
    if device not in ("cuda", "cpu"):
        return _refuse(f"--device must be cuda or cpu, not {device!r}")
    from graphaibench_tpu_torch.analytics import run_benchmark

    return run_benchmark(rest[0], resolve_dataset(rest[1]), rest[2:],
                         device=device)


def cmd_info(argv: list[str]) -> int:
    """<dataset> — print meta + degree stats (query_graph_info analog)."""
    if not argv:
        print("usage: info <dataset>")
        return 2
    import numpy as np

    from graphaibench_tpu_torch.graph.io import load_graph, read_meta

    path = resolve_dataset(argv[0])
    if os.path.exists(path + ".meta.json"):
        from graphaibench_tpu_torch.compress.cli import (
            decode_any,
            load_compressed,
        )

        try:
            g = decode_any(load_compressed(path))
        except (KeyError, ValueError, OSError) as e:
            return _refuse(f"not a compressed-graph prefix: {path} ({e!r})")
        deg = g.degrees()
        print(f"(compressed prefix, decoded) |V| {g.nv} |E| {g.ne}")
        print(f"max_degree {deg.max()}  avg_degree {deg.mean():.2f}")
        return 0
    meta = read_meta(path)
    g = load_graph(path, with_vlabels=True, mmap=True)
    deg = g.degrees()
    print(f"|V| {g.nv} |E| {g.ne}")
    print(f"max_degree {deg.max()}  avg_degree {deg.mean():.2f}  "
          f"min_degree {deg.min()}")
    if g.is_bipartite():
        print(f"bipartite: {g.n_left} x {g.n_right}")
    if meta.feat_len:
        print(f"feat_len {meta.feat_len}")
    if meta.num_vertex_classes:
        print(f"vertex classes {meta.num_vertex_classes}")
    if g.vlabels is not None:
        print(f"vlabels present ({len(np.unique(np.asarray(g.vlabels)))} "
              f"distinct)")
    for name, rng in (("train", meta.train), ("val", meta.val),
                      ("test", meta.test)):
        if rng:
            print(f"{name}_range [{rng[0]}, {rng[1]}) count {rng[2]}")
    # short degree histogram (pow2 bins, GraphT::degree_histogram)
    bins = np.bincount(np.ceil(np.log2(np.maximum(deg, 1) + 1)).astype(int))
    hist = " ".join(f"2^{i}:{c}" for i, c in enumerate(bins) if c)
    print(f"degree histogram {hist}")
    return 0


def cmd_compress(argv: list[str]) -> int:
    """compress|decompress|verify|info ... — the compressed-graph codecs."""
    from graphaibench_tpu_torch.compress.cli import main as compress_main

    return compress_main(argv)


def cmd_partition(argv: list[str]) -> int:
    """``partition <dataset> <num_parts> <out-prefix>``: the induced
    1-hop-halo partitions as ``<prefix>-part<i>`` binary CSR directories
    (the reference's offline partitioner, graph_partition.cc:18-35), the
    files byte-equal to the JAX CLI's."""
    if len(argv) != 3:
        print("usage: partition <dataset> <num_parts> <out-prefix>")
        return 2
    from graphaibench_tpu_torch.graph.io import load_graph
    from graphaibench_tpu_torch.graph.partition import write_partitions

    g = load_graph(resolve_dataset(argv[0]))
    parts = write_partitions(g, int(argv[1]), argv[2], verbose=True)
    for i, p in enumerate(parts):
        print(f"subgraph[{i}]: masters {p.num_masters} "
              f"local |V| {p.subgraph.nv} |E| {p.subgraph.ne} "
              f"range [{p.global_range[0]}, {p.global_range[1]})")
    return 0


def main() -> int:
    commands = {"train": cmd_train, "analytics": cmd_analytics,
                "info": cmd_info, "compress": cmd_compress,
                "partition": cmd_partition}
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        print("usage: graphaibench_tpu_torch.cli "
              "train|analytics|info|compress|partition ...")
        return 2
    return commands[sys.argv[1]](sys.argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
