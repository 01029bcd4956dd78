"""The program's own spans in a trace: which ``gab.`` range of the port
launched each device operation.

The port names its phases with ``utils/timers.py::span`` (``gab.forward``,
``gab.backward``, ``gab.dropout``, ``gab.spmm.adjoint`` ...), recorded only
while a profiler runs. A span is a range on the host; the device time it
stands for is that of the operations launched inside it:

* the launch calls are the host operations that enqueue one device
  operation each (``LAUNCH``: kernel launches, copies, fills), those that
  start in the window, sorted by start;
* on the one stream, a program step's launch calls enqueued a run of
  consecutive device operations, the i-th call the run's i-th operation;
* a device operation belongs to the latest-starting span, on any thread,
  that contains the start of its launch call: the innermost.

Self-check, step by step: a program step's launch calls must match its
device operations kind for kind (a copy, a fill or a kernel), and a step
that does not is left out (``paired``); where no step is left, every reader
returns None. Times only choose between runs of operations a step apart:
the device's and the host's timestamps in a trace drift apart, by up to 60
ppm or in jumps of milliseconds, so an operation launched on an idle card
can read as starting before its launch call. A span that the program's
steps never entered (``gab.dropout`` where no mask is drawn) reads 0.

    python3 portbench/spans.py --workload <cell> --seed <n>

runs the cell's ``--trace 1`` run (``harness.run_cell``) and prints one
JSON line of its trace (``summary``): device milliseconds per step by phase
and by span, the idle time inside and outside the program's steps, and the
idle gaps by label.
"""

from __future__ import annotations

import bisect
import re

PREFIX = "gab."
STEP = "gab.train_epoch"
# the step's phases: each device operation of a step lies in one of them
PHASES = ("gab.forward", "gab.backward", "gab.optimizer", "gab.report",
          "gab.dropout")
LAUNCH = re.compile(
    r"cudaLaunchKernel(ExC)?|cuLaunchKernel(Ex)?|cudaMemcpy(Async)?"
    r"|cudaMemset(Async)?")


def _kind(name: str, prefix: str) -> str:
    """"copy", "fill" or "kernel": a launch call's (``prefix`` "cuda") or
    a device operation's (``prefix`` "")."""
    if name.startswith(prefix + "Memcpy"):
        return "copy"
    return "fill" if name.startswith(prefix + "Memset") else "kernel"


_CHAR = {"copy": "c", "fill": "f", "kernel": "k"}


def launch_calls(t) -> list:
    """(start, name) of the launch calls that start in the window, sorted."""
    w0, w1 = t.window
    return sorted((s, n) for n, s, _ in t.host_ops
                  if w0 <= s < w1 and LAUNCH.fullmatch(n))


def paired(t) -> tuple | None:
    """(the starts of the launch calls it pairs, their device operations,
    the program steps (``STEP``) they make up), or None where no step of the
    window passes the self-check.

    A step's launch calls, in order, must match a run of consecutive device
    operations kind for kind (copy, fill, kernel); of the runs that match,
    a step apart where steps repeat, the step takes the one that starts
    nearest its first launch call, within half the step's span. A step
    whose calls match no such run is left out: the trace lost one of its
    records, or its window cut off some of its operations because the
    device's timestamps read early or late against the host's."""
    calls, ops = launch_calls(t), t.device_ops
    starts = [s for s, _ in calls]
    text = "".join(_CHAR[_kind(d[0], "")] for d in ops)
    w0, w1 = t.window
    kept, held, steps, end = [], [], 0, 0
    for s0, e0 in sorted((s, e) for n, s, e in t.host_ops
                         if n == STEP and w0 <= s < w1):
        a, b = bisect.bisect_left(starts, s0), bisect.bisect_right(starts, e0)
        if a == b:
            continue
        run = "".join(_CHAR[_kind(n, "cuda")] for _, n in calls[a:b])
        best, j = None, text.find(run, end)
        while j >= 0 and ops[j][1] - starts[a] < (e0 - s0) / 2:
            gap = abs(ops[j][1] - starts[a])
            if gap < (e0 - s0) / 2 and (best is None or gap < best[0]):
                best = (gap, j)
            j = text.find(run, j + 1)
        if best is not None:
            j = best[1]
            kept += starts[a:b]
            held += ops[j:j + b - a]
            steps, end = steps + 1, j + b - a
    return (kept, held, steps) if steps else None


def owners(t, among=None) -> tuple | None:
    """(for each device operation that ``paired`` keeps, in order, the name
    of the latest-starting ``gab.`` span (of ``among`` if given) that
    contains the start of its launch call, or None where no such span
    does; those operations; their steps), None where the pairing's
    self-check fails."""
    pairing = paired(t)
    if pairing is None:
        return None
    launches, ops, steps = pairing
    spans = sorted((s, e, n) for n, s, e in t.host_ops
                   if n.startswith(PREFIX) and (among is None or n in among))
    starts = [s for s, _, _ in spans]
    names = []
    for t0 in launches:
        name = None
        for j in range(bisect.bisect_right(starts, t0) - 1, -1, -1):
            if spans[j][1] >= t0:
                name = spans[j][2]
                break
        names.append(name)
    return names, ops, steps


def seconds_by_span(t, among=None, pattern: str | None = None) -> tuple | None:
    """({owning span (``owners``), None for the operations no span holds:
    device seconds}, steps), only the operations whose name ``pattern``
    matches, if given."""
    owned = owners(t, among)
    if owned is None:
        return None
    names, ops, steps = owned
    pat = re.compile(pattern) if pattern else None
    out: dict = {}
    for (n, s, e), owner in zip(ops, names):
        if pat is None or pat.search(n):
            out[owner] = out.get(owner, 0.0) + (e - s)
    return out, steps


def ms_per_step(t, span: str, among=None, pattern: str | None = None):
    """Device milliseconds per traced step that ``span`` owns (among the
    spans ``among``), 0 where the program's steps never entered it; None
    where the trace has no program step (``STEP``), no device operation or
    no pairing that passes the self-check."""
    if not any(n == STEP for n, _, _ in t.host_ops):
        return None
    owned = seconds_by_span(t, among, pattern)
    if owned is None:
        return None
    secs, steps = owned
    return 1e3 * secs.get(span, 0.0) / steps


def phase_ms_per_step(t, phase: str):
    """A phase's device milliseconds per traced step: the operations whose
    innermost phase span is ``phase`` (a span inside it that is no phase,
    such as ``gab.spmm.adjoint`` in ``gab.backward``, counts in it)."""
    return ms_per_step(t, phase, among=PHASES)


def summary(t) -> dict:
    """One traced window, per step: device milliseconds by phase (``None``
    for what no phase holds) and by span, the phases' share of the paired
    device time, the operations that read as starting before their launch
    calls (the clocks' drift), the idle time inside the program's steps and
    outside them, and the idle gaps by label (``TraceView.breakdown``)."""
    pairing = paired(t)
    out = {"steps": t.steps, "launch_calls": len(launch_calls(t)),
           "device_ops": len(t.device_ops),
           "device_ms_per_step": 1e3 * t.device_s() / t.steps,
           "window_ms_per_step": 1e3 * t.window_s / t.steps,
           "paired_steps": pairing and pairing[2],
           "ops_before_their_launch": pairing and sum(
               1 for s, d in zip(*pairing[:2]) if d[1] < s)}
    if pairing is not None:
        for key, among in (("phase", PHASES), ("span", None)):
            secs, steps = seconds_by_span(t, among)
            out[key + "_ms_per_step"] = {str(k): 1e3 * v / steps
                                         for k, v in secs.items()}
        phases = out["phase_ms_per_step"]
        out["phases_share_of_paired"] = 100.0 * (
            1 - phases.get("None", 0.0) / sum(phases.values()))
    ranges = [(s, e) for n, s, e in t.host_ops if n == STEP]
    inside = sum(max(0.0, min(g1, e) - max(g0, s))
                 for g0, g1 in t.idle_gaps() for s, e in ranges)
    idle = t.window_s - t.busy_s
    out["idle_ms_per_step"] = {"in_program_steps": 1e3 * inside / t.steps,
                               "outside": 1e3 * (idle - inside) / t.steps}
    out["idle_gaps"] = t.breakdown()["idle_gaps"]
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    from portbench import harness, trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: no device trace on the CPU", file=sys.stderr)
        return 3
    views, from_profiler = [], trace.from_profiler

    def keep(prof, **rest):    # the view the traced run's readers read
        views.append(from_profiler(prof, **rest))
        return views[-1]
    trace.from_profiler = keep
    res, _ = harness.run_cell(args.workload, args.seed, 0.0, True, "cuda",
                              time.perf_counter(), root)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": res["correct"], **summary(views[0])}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
