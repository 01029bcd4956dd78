"""Per-stage timing and profiling hooks.

Counterpart of ``graphaibench_tpu/utils/timers.py`` (the reference's
global time_ops map + print_timers, include/gnn/global.h:42-54,
src/gnn/train.cpp:60-76): accumulate host-clock time per tag, print a
breakdown in the same format. A stage that runs on the device is timed
around a device sync (a value fetched to the host), so its seconds include
the device's work. ``profiler_trace`` captures a ``torch.profiler`` trace
in place of the reference's nvprof/VTune hooks (common.mk:41-46), and
``span`` names the program's own ranges inside such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

# stage tags of the training loop, each closed by a device sync
OP_STEP = "step"          # fwd+bwd+optimizer, device-synced
OP_EVAL = "eval"          # full-graph inference + masked accuracy
OP_HALO = "halo"          # sharded halo exchange, when measured alone
OP_SAMPLE = "sample"      # the sampler's wait, not hidden behind a step

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program (``gab.forward``, ``gab.spmm.adjoint``
    ...) in a ``torch.profiler`` trace: ``record_function(name)`` while a
    profiler records, on any thread, so the trace attributes the device
    operations launched inside it. With no profiler running it costs one
    check and returns a shared no-op context: no ``RecordFunction``, no
    allocation."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class OpTimers:
    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def op(self, tag: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[tag] += time.perf_counter() - t0
            self.counts[tag] += 1

    def add(self, tag: str, seconds: float):
        self.times[tag] += seconds
        self.counts[tag] += 1

    def print_timers(self):
        total = sum(self.times.values())
        print("Per-op time breakdown:")
        for tag, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            print(f"  {tag:12s} {t:10.4f} s ({pct:5.1f}%)  x{self.counts[tag]}")
        print(f"  {'total':12s} {total:10.4f} s")

    def reset(self):
        self.times.clear()
        self.counts.clear()


TIMERS = OpTimers()


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed work (host, and the
    device where there is one) and write it as a Chrome trace,
    ``<logdir>/trace.json`` (chrome://tracing, Perfetto)."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
