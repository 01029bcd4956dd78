#!/usr/bin/env python3
"""chip_smoke.py's p15b phase alone on one CUDA card, and the reading of
``sddmm_add`` (K3, ``ops/spmm.py``) in two GAT steps.

Run from the root of a checkout (``PYTHONPATH=.``), on a machine with a
card:

    python3 tools/p15b_phase.py [--sddmm-add-only]

Prints the card (nvidia-smi name and power limit) and builds the kernels;
then ``chip_smoke.phase_p15b`` with every check of that phase (the NLF on
K1, the motif counts against the exact oracle and at full width, FSM on the
card against the CPU, the ``motif`` and ``fsm`` CLI routes), unless
``--sddmm-add-only``. Then the K3 reading on rmat(17, 16) seed 0 at
chip_smoke's widths (GAT, 2 layers, 128/128/16): under torch.profiler, the
device ms a step of ``sddmm_add``'s forward (two (E,) gathers and an add)
and of its adjoint (``_SddmmAdd.backward``), each run inside a profiler
range (its host-side event's device time, and the kernels launched
inside it by name), against the step's device time (every kernel, copy
and memset of the profiled steps, not the ranges' device-side spans), in
(a) a sampled step at subg_size 32768, whose subgraph has no ELL buckets,
and (b) a full-batch step with score dropout 0.3, which takes the unfused
layer. One ``[k3] {json}`` line a step kind.
Exits with another code than 0 where a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke as cs
from graphaibench_tpu_torch import rmat
from graphaibench_tpu_torch.nn import Model, make_config
from graphaibench_tpu_torch.nn import layers as NL
from graphaibench_tpu_torch.ops import spmm as SP

WARM_STEPS = 2
PROFILED_STEPS = 5
SCORE_DROP = 0.3
RANGES = ("sddmm_add forward", "sddmm_add backward")


class _traced_sddmm_add:
    """While active, the GAT layer's ``sddmm_add`` and its adjoint run
    inside the profiler ranges RANGES."""

    def __enter__(self):
        self.fwd, self.bwd = NL.sddmm_add, SP._SddmmAdd.backward
        fwd, bwd = self.fwd, self.bwd

        def traced(g, sa, sb):
            with record_function(RANGES[0]):
                return fwd(g, sa, sb)

        def traced_bwd(ctx, ct):
            with record_function(RANGES[1]):
                return bwd(ctx, ct)

        NL.sddmm_add = traced
        SP._SddmmAdd.backward = staticmethod(traced_bwd)

    def __exit__(self, *exc):
        NL.sddmm_add = self.fwd
        SP._SddmmAdd.backward = staticmethod(self.bwd)


def _kernels_under(e, out: dict) -> None:
    """Device ms of the kernels that ``e`` and the ops under it launched,
    added to ``out`` by kernel name."""
    for k in e.kernels:
        out[k.name] = out.get(k.name, 0.0) + k.duration / 1e3
    for child in e.cpu_children:
        _kernels_under(child, out)


def _reading(tag: str, run) -> dict:
    """``run(n)`` takes n steps: WARM_STEPS warm, then PROFILED_STEPS under
    the profiler with sddmm_add traced. Device ms a step of every device
    event (kernels, copies, memsets; the ranges' own device-side spans
    left out), of the kernels launched inside each range, and the ranges'
    share."""
    run(WARM_STEPS)
    torch.cuda.synchronize()
    with _traced_sddmm_add(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        run(PROFILED_STEPS)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda and e.name not in RANGES]
    if not dev:
        raise RuntimeError(f"[k3] {tag}: the profiler recorded no device "
                           "event")
    step_us = sum(e.time_range.elapsed_us() for e in dev)
    ranges = {name: [0, 0.0, {}] for name in RANGES}
    for e in events:
        if e.device_type != cuda and e.name in ranges:
            ranges[e.name][0] += 1
            ranges[e.name][1] += e.device_time_total
            _kernels_under(e, ranges[e.name][2])
    if ranges[RANGES[0]][0] == 0:
        raise RuntimeError(f"[k3] {tag}: sddmm_add never ran")
    k3_us = sum(us for _, us, _ in ranges.values())
    info = {"steps": PROFILED_STEPS,
            "step_device_ms": step_us / PROFILED_STEPS / 1e3,
            "device_ops_per_step": len(dev) / PROFILED_STEPS}
    for name, (n, us, by) in ranges.items():
        key = name.replace(" ", "_")
        info[f"{key}_ms"] = us / PROFILED_STEPS / 1e3
        info[f"{key}_calls_per_step"] = n / PROFILED_STEPS
        info[f"{key}_kernels_ms"] = {k[:70]: v / PROFILED_STEPS
                                     for k, v in sorted(by.items())}
    info["share_of_step"] = k3_us / step_us
    print(f"[k3] {tag} {json.dumps(info)}")
    return info


def phase_k3() -> dict:
    g = rmat(cs.SCALE, cs.EDGE_FACTOR, seed=0)
    ds = cs._dataset(g, cs.FEAT, cs.CLASSES)
    cfg = make_config("gat", cs.GAT_LAYERS, cs.FEAT, cs.HIDDEN, cs.CLASSES,
                      lr=0.01, subg_size=cs.SUBG_SIZE)
    sampled = Model(cfg, ds, device="cuda", inductive=True)
    out = {"sampled": _reading(
        f"sampled gat rmat{cs.SCALE} subg_size {cs.SUBG_SIZE}",
        lambda n: sampled.train_sampled(n, cs.SUBG_SIZE, verbose=False))}
    del sampled
    cfg = make_config("gat", cs.GAT_LAYERS, cs.FEAT, cs.HIDDEN, cs.CLASSES,
                      lr=0.01)
    full = Model(dataclasses.replace(cfg, score_drop=SCORE_DROP), ds,
                 device="cuda")
    out["unfused"] = _reading(
        f"unfused gat rmat{cs.SCALE} score_drop {SCORE_DROP}",
        lambda n: full.train(n, verbose=False))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sddmm-add-only", action="store_true")
    args = ap.parse_args()
    cs.phase_device()
    cs._timed("build", cs.phase_build)
    if not args.sddmm_add_only:
        cs._timed("p15b", cs.phase_p15b)
    print(json.dumps({"k3": cs._timed("k3", phase_k3)}))


if __name__ == "__main__":
    main()
