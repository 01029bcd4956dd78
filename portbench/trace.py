"""From a profiler trace of the window to what the per-layer metrics read.

``TraceView`` holds the device operations (kernels, copies, fills) and the
host operations of the traced steps, the traced window (from the first
step's start to the last step's end, by the benchmark's own span around
each step), the step's work model and the card's peaks. The readers in
``portbench/metrics/`` take their numbers from it; a reader that finds
nothing to read returns None.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

STEP_SPAN = "portbench.step"
NAME_CHARS = 120


@dataclasses.dataclass
class TraceView:
    device_ops: list          # (name, start_s, end_s), sorted by start
    host_ops: list            # (name, start_s, end_s)
    window: tuple             # (start_s, end_s)
    steps: int
    kernels: dict             # kernel name -> module (PATTERN, work)
    ops: list                 # the step's work model (workmodel.Op)
    model_flops: int          # per step
    peaks: dict | None
    memory: dict              # held_bytes, window_peak_bytes

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        busy, end = 0.0, self.window[0]
        for _, s, e in self.device_ops:
            s, e = max(s, end), min(e, self.window[1])
            if e > s:
                busy += e - s
                end = e
        return busy

    def device_s(self) -> float:
        return sum(e - s for _, s, e in self.device_ops)

    def kernel_s(self, kernel: str) -> float:
        """Summed device seconds of the operations ``kernel`` names."""
        pat = re.compile(self.kernels[kernel].PATTERN)
        return sum(e - s for n, s, e in self.device_ops if pat.search(n))

    def bound_s(self, kernel: str) -> float | None:
        """The least seconds a step's operations of ``kernel`` could take on
        this card: per operation the larger of its bytes over the memory
        rate and its FLOPs over the float32 rate."""
        if self.peaks is None:
            return None
        total, found = 0.0, False
        for op in self.ops:
            w = self.kernels[kernel].work(op)
            if w is None:
                continue
            nbytes, flops = w
            total += max(nbytes / self.peaks["hbm_bytes_per_s"],
                         flops / self.peaks["f32_flops"])
            found = True
        return total if found else None

    def roofline_share(self, kernel: str) -> float | None:
        """The kernel's share of its roofline in %: the least time of the
        traced steps' operations over the kernel's summed device time."""
        t, bound = self.kernel_s(kernel), self.bound_s(kernel)
        if not t or bound is None:
            return None
        return 100.0 * bound * self.steps / t

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        largest sums of idle gaps by the innermost host operation running
        at each gap's middle."""
        ops: dict[str, float] = {}
        for n, s, e in self.device_ops:
            ops[n[:NAME_CHARS]] = ops.get(n[:NAME_CHARS], 0.0) + (e - s)
        gaps: dict[str, float] = {}
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for g0, g1 in self.idle_gaps():
            label = _host_at(host, starts, (g0 + g1) / 2)
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}

    def idle_gaps(self) -> list:
        """(start_s, end_s) of each stretch of the window with no device
        operation running."""
        gaps, end = [], self.window[0]
        for _, s, e in self.device_ops:
            if s > end:
                gaps.append((end, min(s, self.window[1])))
            end = max(end, e)
        if end < self.window[1]:
            gaps.append((end, self.window[1]))
        return [(a, b) for a, b in gaps if b > a]


def _host_at(host: list, starts: list, t: float, scan: int = 4096) -> str:
    """The name of the latest-starting host operation running at ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - scan, -1), -1):
        if host[j][2] >= t:
            return host[j][0][:NAME_CHARS]
    return "python between traced operations"


def from_profiler(prof, **rest) -> TraceView:
    """A ``TraceView`` of the steps that ``prof`` (a stopped
    ``torch.profiler.profile``) recorded, each inside a ``STEP_SPAN``, but
    the first, whose device events the profiler's start may have missed."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.events():
        item = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            # the device side of a span is no operation of the device
            if e.name != STEP_SPAN and not getattr(e, "is_user_annotation",
                                                   False):
                device.append(item)
        elif e.name == STEP_SPAN:
            spans.append(item)
        else:
            host.append(item)
    spans = sorted(spans, key=lambda s: s[1])[1:]
    if not spans:
        raise RuntimeError("the trace holds no step span after the first")
    window = (spans[0][1], max(e for _, _, e in spans))
    device = sorted((d for d in device if window[0] <= d[1] < window[1]),
                    key=lambda d: d[1])
    return TraceView(device_ops=device, host_ops=host, window=window,
                     steps=len(spans), **rest)
