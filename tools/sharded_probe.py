#!/usr/bin/env python3
"""Where the sharded trainer's step spends its host time, and how far two
runs of the same training differ, on one CUDA card.

Run from the root of a checkout (``PYTHONPATH=.``), on a machine with a
card:

    python3 tools/sharded_probe.py [--scale 17] [--runs 3] [--steps 10]
    python3 tools/sharded_probe.py --ranks 4     # on a machine with 4 cards
    python3 tools/sharded_probe.py --ranks 4 --analytics
    python3 tools/sharded_probe.py --sensitivity
    python3 tools/sharded_probe.py --grads
    python3 tools/sharded_probe.py --phase 3

For GCN and GAT of chip_smoke.py's main path (2 layers, 128/128/16 on
rmat(scale, 16) with self-loops):

1. spread: ``--runs`` fresh ``Model`` runs and ``--runs`` one-rank sharded
   runs (an nccl group of one, in this process) of chip_smoke's
   SHARDED_STEPS steps each; the largest |weight difference| of each from
   the first ``Model`` run, per parameter, and after each step, and each
   gradient's largest |difference| over its tensor's largest |gradient|
   at each step. Atomics add in an order that changes from run to run,
   so this is the noise a weight comparison between the two trainers has
   to allow. Each sharded run then takes SHARDED_STEPS steps from fresh
   weights with ``Model`` following it (chip_smoke's ``_follow``): the
   noise left where nothing compounds.
2. host: ``--steps`` warm steps of each trainer under torch.profiler (CPU
   and CUDA): the host clock a step, the device's busy time a step, and
   the host ops that take the most self CPU time a step.

With ``--ranks N`` instead: N ranks spawned one a card (nccl), GCN and GAT
3 steps each (chip_smoke's ``_sharded_rank``), each rank's losses and the
summed weights held to ``Model`` on card 0 as chip_smoke's sharded phase
holds them, with halo_counts, h_max, the launches a step and
``halo_probe``; then ``cli train gcn`` with ``GAB_SHARDS=auto`` on
rmat(13, 8).

With ``--ranks N --tp M[,M...]``: for each M, the tensor-parallel trainer
on N ranks, one a card (nccl), as (N / M graph x M model): GCN and GAT
(l2norm and dense head) chip_smoke's TP_STEPS steps, the ranks equal to
each other and held to ``Model`` on card 0 as chip_smoke's tp_dp phase
holds them, with the launches a step. With ``--ranks N --dp``:
data-parallel GraphSAINT on N ranks, one a card, the first step's
averaged gradients held to the serial mean (chip_smoke's ``_tp_dp_dp``).
Either skips the 1-D run above.

With ``--ranks N --analytics``: the distributed analytics on
chip_smoke's analytics graph (rmat(19, 16), symmetric; ``--scale`` sets
another): the solvers of
chip_smoke's dist_analytics phase at one nccl rank in this process on
card 0, held to the single-device solvers, then at N ranks spawned one a
card (nccl), held to the one rank as that phase holds two gloo ranks (the
same sweep, iteration and level counts), with each rank's set-up and
solve seconds, launches a solve and peak memory; then ``cli analytics
<kernel>`` with ``GAB_SHARDS=auto`` for the seven kernels on rmat(13, 8),
four processes at a time, each of which must print Correct.

With ``--sensitivity`` instead: how far a wrong GAT gradient reads
against chip_smoke's limits. One ``Model`` run of GAT is the reference;
then one-rank sharded runs of SHARDED_STEPS steps, each with one gradient
of the fused attention's backward (d_sl, d_sr or d_h) scaled by a
factor inside this process only, and a run with none; each run's losses'
largest relative error and its weights' largest |difference| from the
reference, the first step's gradients' differences, and ``_follow``'s
differences with the fault in the trainer's steps only, beside
SHARDED_RTOL, SHARDED_ATOL["gat"], SHARDED_FOLLOW_ATOL, TP_GRAD_RTOL and
TP_GRAD_ATOL.

With ``--grads`` instead: the first step's gradients of GCN and GAT at
one rank (in this process) and at two gloo ranks on the card against
``Model``'s, per parameter: the largest |difference| and |gradient|,
whether chip_smoke's tensor-parallel gradient limits hold element by
element, and the difference's largest singular value's share of its
norm.

With ``--phase N`` instead: chip_smoke's sharded phase N times, with
every check of that phase (the one-rank and two-rank runs against
``Model``, ``Model`` following each, the rank tables' kernels).

Prints one JSON object per measurement, and the cards' nvidia-smi lines
first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from graphaibench_tpu_torch import rmat
from graphaibench_tpu_torch.nn import Model


def _model(g, cfg):
    return Model(cfg, cs._dataset(g, cfg.dim_init, cfg.num_cls), device="cuda")


def _fresh(cfg):
    """Fresh weights and optimizer on the card."""
    params = cs.init_params(cfg, device="cuda")
    return params, cs.OPTIMIZERS[cfg.optimizer](params.parameters(),
                                                 lr=cfg.lr)


def _trajectory(params, step) -> dict:
    """SHARDED_STEPS calls of ``step``; the weights and the gradients by
    name after each."""
    out = {"params": [], "grads": []}
    for _ in range(cs.SHARDED_STEPS):
        step()
        out["params"].append(cs._params_by_name(params))
        out["grads"].append(cs._grads_by_name(params))
    return out


def _spread(g, cfg, runs: int) -> list[dict]:
    def trained_model():
        m = _model(g, cfg)
        return _trajectory(m.params, m.train_epoch)

    def trained_sharded():
        _, trainer, params, opt = cs._sharded_setup(g, cfg, 1, "cuda")
        out = _trajectory(params, lambda: trainer.train_step(params, opt))
        params, opt = _fresh(cfg)
        out["follow"] = cs._follow(lambda: trainer.train_step(params, opt),
                                   params, opt, follower,
                                   cs.SHARDED_STEPS)
        return out

    ref = trained_model()
    follower = _model(g, cfg)
    out = []
    for kind, fn in (("model", trained_model), ("sharded", trained_sharded)):
        for run in range(runs):
            got = fn()
            out.append({
                "arch": cfg.arch, "kind": kind, "run": run,
                "max_abs_diff": {k: float(np.abs(got["params"][-1][k] - v)
                                          .max())
                                 for k, v in ref["params"][-1].items()},
                # each step: the largest |weight difference| over the
                # parameters, and each gradient's largest |difference|
                # over its tensor's largest |gradient|
                "weights_by_step": [
                    cs._weights_err(a, b)
                    for a, b in zip(got["params"], ref["params"])],
                "grad_rel_by_step": [
                    {k: float(np.abs(a[k] - v).max())
                     / max(float(np.abs(v).max()), 1e-30)
                     for k, v in b.items()}
                    for a, b in zip(got["grads"], ref["grads"])],
                "grad_abs_step1": {
                    k: float(np.abs(got["grads"][0][k] - v).max())
                    for k, v in ref["grads"][0].items()},
                "grad_max_step1": {k: float(np.abs(v).max())
                                   for k, v in ref["grads"][0].items()},
                "follow": got.get("follow")})
    return out


GAT_GRADS = ("d_sl", "d_sr", "d_h")
FAULTS = ((None, 1.0), ("d_sr", 0.99), ("d_sl", 0.99), ("d_h", 0.99),
          ("d_sr", 0.999), ("d_h", 0.999))


def _sensitivity(g) -> None:
    from graphaibench_tpu_torch.ops import fused_gat as FG

    cfg = cs._sharded_cfgs()["gat"]
    model = _model(g, cfg)
    want_losses, want_grads = [], None
    for _ in range(cs.SHARDED_STEPS):
        want_losses.append(model.train_epoch()[0])
        want_grads = want_grads or cs._grads_by_name(model.params)
    want = cs._params_by_name(model.params)
    backward = FG._GatV2.backward
    try:
        for grad, factor in FAULTS:
            def scaled(ctx, ct, grad=grad, factor=factor):
                out = list(backward(ctx, ct))
                if grad is not None:
                    k = 2 + GAT_GRADS.index(grad)
                    out[k] = out[k] * factor
                return tuple(out)

            FG._GatV2.backward = staticmethod(scaled)
            _, trainer, params, opt = cs._sharded_setup(g, cfg, 1, "cuda")
            grads = {}
            losses, _, _ = cs._sharded_steps(trainer, params, opt,
                                             cs.SHARDED_STEPS,
                                             first_grads=grads)
            got = cs._params_by_name(params)
            # the fault in the trainer's steps only, Model following it
            FG._GatV2.backward = backward
            params, opt = _fresh(cfg)

            def faulty_step(params=params, opt=opt, scaled=scaled):
                FG._GatV2.backward = staticmethod(scaled)
                try:
                    trainer.train_step(params, opt)
                finally:
                    FG._GatV2.backward = backward

            follow = cs._follow(faulty_step, params, opt, model,
                                cs.SHARDED_STEPS)
            print(json.dumps({
                "arch": "gat", "grad": grad, "factor": factor,
                "losses_max_rel_err": max(
                    abs(a - b) / abs(b) for a, b in zip(losses, want_losses)),
                "weights_max_abs_err": cs._weights_err(got, want),
                "by_param": {k: float(np.abs(got[k] - v).max())
                             for k, v in want.items()},
                # the first step's gradients: each one's largest
                # |difference| over its tensor's largest |gradient|
                "grad_rel_step1": {
                    k: float(np.abs(grads[k] - v).max())
                    / max(float(np.abs(v).max()), 1e-30)
                    for k, v in want_grads.items()},
                "follow": follow,
                "rtol": cs.SHARDED_RTOL, "atol": cs.SHARDED_ATOL["gat"],
                "follow_atol": cs.SHARDED_FOLLOW_ATOL,
                "grad_rtol": cs.TP_GRAD_RTOL, "grad_atol": cs.TP_GRAD_ATOL}))
    finally:
        FG._GatV2.backward = backward


def _first_grads(rank: int, n: int, row_ptr, col_idx) -> dict:
    """One rank of ``--grads``: GCN and GAT, one step from fresh weights
    on ``n`` shards; the gradients by name (summed over the ranks)."""
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.parallel.multihost import rank_device

    g = CSRGraph(row_ptr=row_ptr, col_idx=col_idx)
    dev = rank_device(rank, "cuda") if n > 1 else "cuda"
    out = {}
    for arch, cfg in cs._sharded_cfgs().items():
        _, trainer, params, opt = cs._sharded_setup(g, cfg, n, dev)
        trainer.train_step(params, opt)
        out[arch] = cs._grads_by_name(params)
    return out


def _grads_against_model(g) -> None:
    """``--grads``: the first step's gradients of the one-rank trainer (in
    this process) and of rank 0 of two gloo ranks on the card, each
    against ``Model``'s: per parameter the largest |difference|, the
    largest |gradient|, whether chip_smoke's tensor-parallel limits
    (TP_GRAD_RTOL, TP_GRAD_ATOL) hold element by element, and for a matrix
    the share of the difference's Frobenius norm in its largest singular
    value (about 2 / sqrt(n) for rounding noise, near 1 for a fault in a
    few rows)."""
    want = {}
    for arch, cfg in cs._sharded_cfgs().items():
        m = _model(g, cfg)
        m.train_epoch()
        want[arch] = cs._grads_by_name(m.params)
        del m
    one = _first_grads(0, 1, g.row_ptr, g.col_idx)
    two = cs.PAR.launch(_first_grads, 2, g.row_ptr, g.col_idx,
                        device="cuda", backend="gloo",
                        timeout_s=cs.SHARDED_SPAWN_TIMEOUT_S)[0]
    for ranks, got in ((1, one), (2, two)):
        for arch, grads in got.items():
            rec = {}
            for k, w in want[arch].items():
                d = grads[k] - w
                share = None
                if d.ndim == 2 and np.abs(d).max() > 0:
                    sv = np.linalg.svd(d.astype(np.float64),
                                       compute_uv=False)
                    share = float(sv[0] / np.sqrt((sv ** 2).sum()))
                rec[k] = {"max_abs_diff": float(np.abs(d).max()),
                          "max_abs_grad": float(np.abs(w).max()),
                          "tp_limits_hold": bool(np.allclose(
                              grads[k], w, rtol=cs.TP_GRAD_RTOL,
                              atol=cs.TP_GRAD_ATOL)),
                          "top_singular_share": share}
            print(json.dumps({"arch": arch, "ranks": ranks, "grads": rec}))


def _host(tag: str, step, steps: int) -> dict:
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    host = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:12]
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)
    return {"trainer": tag, "steps": steps,
            "host_ms_per_step": wall / steps * 1e3,
            "device_busy_ms_per_step": busy / steps / 1e3,
            "top_self_cpu_ms_per_step": [
                [e.key[:80], e.count / steps,
                 e.self_cpu_time_total / steps / 1e3] for e in host]}


def _multi_rank(g, n: int) -> None:
    steps = cs.SHARDED_STEPS_TWO
    t0 = time.perf_counter()
    ranks = cs.PAR.launch(cs._sharded_rank, n, g.row_ptr, g.col_idx, steps,
                          device="cuda", timeout_s=600)
    print(json.dumps({"ranks": n, "launch_s": time.perf_counter() - t0}))
    for arch, cfg in cs._sharded_cfgs().items():
        model = _model(g, cfg)
        losses = [model.train_epoch()[0] for _ in range(steps)]
        want = cs._params_by_name(model.params)
        r0 = ranks[0][arch]
        for r in ranks[1:]:
            if r[arch]["losses"] != r0["losses"] or any(
                    not np.array_equal(v, r[arch]["params"][k])
                    for k, v in r0["params"].items()):
                raise RuntimeError(f"{arch}: the ranks' losses or weights "
                                   "differ")
        err = cs._hold_to_model(f"[{n} ranks {arch}]", arch, r0["losses"],
                                r0["params"], losses, want)
        print(json.dumps({
            "arch": arch, "ranks": n, "transport": r0["transport"],
            "losses": r0["losses"], "model_losses": losses,
            "weights_max_abs_err": err, "halo_counts": r0["halo_counts"],
            "h_max": r0["h_max"], "nv_pad": r0["nv_pad"],
            "launches_per_step": [{k: v // steps for k, v in
                                   r[arch]["launches"].items() if v}
                                  for r in ranks],
            "halo_probe_s": [r[arch]["halo_probe_s"] for r in ranks]}))
    from graphaibench_tpu_torch.graph.io import Meta, save_graph

    with tempfile.TemporaryDirectory() as tmp:
        small = rmat(13, 8, seed=0)
        nv = small.nv
        save_graph(small, tmp, meta=Meta(
            nv=nv, ne=small.ne, num_vertex_classes=4,
            train=(0, nv // 2, nv // 2), val=(nv // 2, nv, nv - nv // 2),
            test=(nv // 2, nv, nv - nv // 2)))
        r = subprocess.run(
            [sys.executable, "-m", "graphaibench_tpu_torch.cli", "train",
             "gcn", tmp, "3", "0", "softmax", "16", "0", "0", "0.02", "2",
             "0", "2", "--timers"],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, GAB_SHARDS="auto"))
        print(r.stdout[-3000:])
        if r.returncode != 0 or f"{n} rank(s)" not in r.stdout:
            raise RuntimeError(f"cli GAB_SHARDS=auto: exit {r.returncode}\n"
                               f"{r.stderr[-3000:]}")


def _analytics_multi_rank(n: int, scale: int) -> None:
    from graphaibench_tpu_torch.graph.io import save_graph
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    g = rmat(scale, cs.EDGE_FACTOR, seed=0)
    dg = to_device_graph(g, device="cuda")
    w = np.random.default_rng(2).uniform(0.1, 2.0, g.ne).astype(np.float32)
    refs = cs._dist_refs(g, dg, w)
    del dg
    card0 = torch.device("cuda", 0)
    cs.PAR.initialize(0, 1, port=cs.PAR.multihost.free_port(),
                      backend="nccl", device=card0)
    try:
        one = cs._dist_solves(g, w, card0)
    finally:
        cs.PAR.multihost.dist.destroy_process_group()
    one_solves = cs._dist_report("[analytics 1 rank nccl]", one)
    errs = cs._dist_hold("[analytics 1 rank nccl]", one["solves"], refs)
    print(json.dumps({"one_rank_against_single_device_max_abs_diff": errs}))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = cs.PAR.launch(cs._dist_rank, n, g.row_ptr, g.col_idx, w,
                          device="cuda", timeout_s=900)
    print(json.dumps({"ranks": n, "launch_s": time.perf_counter() - t0}))
    for r, res in enumerate(ranks):
        cs._dist_report(f"[analytics {n} ranks rank {r}]", res)
    errs = cs._dist_hold(f"[analytics {n} ranks against 1]",
                         ranks[0]["solves"],
                         {k: v["result"] for k, v in one["solves"].items()})
    for name, rec in one_solves.items():
        counts = {r["solves"][name]["count"] for r in ranks}
        if counts != {rec["count"]}:
            raise RuntimeError(f"{name}: counts {counts} at {n} ranks, "
                               f"{rec['count']} at 1")
    print(json.dumps({"ranks": n, "transport": ranks[0]["transport"],
                      "against_one_rank_max_abs_diff": errs}))
    with tempfile.TemporaryDirectory() as tmp:
        save_graph(rmat(13, 8, seed=0), tmp)
        env = dict(os.environ, GAB_SHARDS="auto")
        kernels = list(cs.CLI_KERNELS)
        for lo in range(0, len(kernels), 4):
            procs = {k: subprocess.Popen(
                [sys.executable, "-m", "graphaibench_tpu_torch.cli",
                 "analytics", k, tmp, "0"], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env)
                for k in kernels[lo:lo + 4]}
            for k, p in procs.items():
                out, err = p.communicate(timeout=600)
                print(f"[cli analytics {k} GAB_SHARDS=auto]\n{out}")
                if (p.returncode != 0 or "Correct" not in out.splitlines()
                        or f"distributed over {n} rank(s)" not in out):
                    raise RuntimeError(f"cli analytics {k}: exit "
                                       f"{p.returncode}\n{err[-3000:]}")


def _tp_multi_rank(g, n: int, tps: list[int]) -> None:
    models = cs._tp_models(g)
    for m in tps:
        shards = n // m
        t0 = time.perf_counter()
        ranks = cs.PAR.launch(cs._tp_rank, n, g.row_ptr, g.col_idx, shards,
                              ("gcn", "gat"), cs.TP_STEPS, None,
                              device="cuda", timeout_s=600)
        print(json.dumps({"ranks": n, "layout": f"({shards}x{m})",
                          "launch_s": time.perf_counter() - t0}))
        for arch in ("gcn", "gat"):
            cs._tp_hold(f"[tp {arch} ({shards}x{m}) nccl]", arch, ranks,
                        models[arch], cs.TP_STEPS, shards,
                        transport="device")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=None,
                    help=f"rmat scale (default {cs.SCALE}; with "
                         f"--analytics {cs.ANALYTICS_SCALE})")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn this many ranks, one a card (nccl)")
    ap.add_argument("--sensitivity", action="store_true",
                    help="GAT against Model with one gradient scaled")
    ap.add_argument("--tp", default="",
                    help="with --ranks: the model parallelisms to run, "
                         "comma-separated")
    ap.add_argument("--dp", action="store_true",
                    help="with --ranks: data-parallel GraphSAINT")
    ap.add_argument("--analytics", action="store_true",
                    help="with --ranks: the distributed analytics")
    ap.add_argument("--grads", action="store_true",
                    help="first-step gradients at one and two ranks "
                         "against Model's")
    ap.add_argument("--phase", type=int, default=0,
                    help="run chip_smoke's sharded phase this many times")
    args = ap.parse_args()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(cards)
    try:
        _run(args)
    finally:
        print(cards)


def _run(args) -> None:
    cs.phase_build()
    if args.ranks and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"--ranks {args.ranks}: "
                         f"{torch.cuda.device_count()} card(s)")
    if args.ranks and args.analytics:
        _analytics_multi_rank(args.ranks, args.scale or cs.ANALYTICS_SCALE)
        return
    g = rmat(args.scale or cs.SCALE, cs.EDGE_FACTOR, seed=0)
    if args.phase:
        for _ in range(args.phase):
            cs._timed("sharded", cs.phase_sharded, g)
        return
    if args.ranks:
        if args.tp:
            _tp_multi_rank(g, args.ranks,
                           [int(m) for m in args.tp.split(",")])
        if args.dp:
            cs._tp_dp_dp(g, args.ranks, backend=None)
        if not (args.tp or args.dp):
            _multi_rank(g, args.ranks)
        return
    cs.PAR.initialize(0, 1, port=cs.PAR.multihost.free_port(),
                      backend="nccl", device=torch.device("cuda", 0))
    try:
        if args.sensitivity:
            _sensitivity(g)
            return
        if args.grads:
            _grads_against_model(g)
            return
        for cfg in cs._sharded_cfgs().values():
            for rec in _spread(g, cfg, args.runs):
                print(json.dumps(rec))
            model = _model(g, cfg)
            print(json.dumps({"arch": cfg.arch, **_host(
                "model", model.train_epoch, args.steps)}))
            _, trainer, params, opt = cs._sharded_setup(g, cfg, 1, "cuda")
            print(json.dumps({"arch": cfg.arch, **_host(
                "sharded one rank",
                lambda: float(trainer.train_step(params, opt)),
                args.steps)}))
    finally:
        cs.PAR.multihost.dist.destroy_process_group()


if __name__ == "__main__":
    main()
