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
``DIR/trace.json``). The multi-device routes (``GAB_SHARDS``, ``GAB_DP``)
are not ported yet: they exit with code 2 and name their ROADMAP item.

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
    if os.environ.get("GAB_SHARDS", "") and subg_size == 0 and not inductive:
        # as in the JAX CLI, GAB_SHARDS routes full-batch training only
        return _refuse("GAB_SHARDS: the sharded trainer is not ported yet "
                       "(ROADMAP queue 1, P14)")
    if subg_size > 0 and int(os.environ.get("GAB_DP", "1")) > 1:
        return _refuse("GAB_DP: data-parallel GraphSAINT is not ported yet "
                       "(ROADMAP queue 1, P14)")

    path = resolve_dataset(argv[1])
    if os.path.exists(path + ".meta.json"):
        return _refuse("train does not accept compressed-graph prefixes; "
                       "decompress first")
    from graphaibench_tpu_torch.graph.io import (
        load_gnn_dataset,
        load_gnn_dataset_csgr,
    )
    from graphaibench_tpu_torch.nn import Model, make_config
    from graphaibench_tpu_torch.utils.timers import TIMERS, profiler_trace

    is_sigmoid = loss == "sigmoid"
    if glob.glob(os.path.join(path, "*.csgr")):
        ds = load_gnn_dataset_csgr(path, is_single_class=not is_sigmoid)
    else:
        ds = load_gnn_dataset(path, is_single_class=not is_sigmoid)
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


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] != "train":
        print("usage: graphaibench_tpu_torch.cli train ... "
              "(analytics, compress, partition and info: ROADMAP queue 1)")
        return 2
    return cmd_train(sys.argv[2:])


if __name__ == "__main__":
    raise SystemExit(main())
