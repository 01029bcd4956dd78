"""The readers of the program's spans (``portbench/spans.py``) on traces
built by hand: device operations paired with launch calls by order, owned
by the innermost span across threads, all None when the pairing's
self-check fails, unmoved by a drift between the device's and the host's
clocks, and the phases summing to the device time."""

from __future__ import annotations

import pytest

from portbench import harness, spans, trace

K1 = "void ell_spmm_kernel<1>(Table, float const*, float*)"
READERS = ("fwd.ms_per_step", "bwd.ms_per_step", "opt.ms_per_step",
           "dropout.ms_per_step", "k1.adjoint_ms_per_step")


def _view(device_ops, host_ops, steps=1, window=(0.0, 10.0)):
    kernels = {"k1": harness.load_module(harness.HERE / "kernels" / "k1.py")}
    return trace.TraceView(device_ops=sorted(device_ops, key=lambda d: d[1]),
                           host_ops=host_ops, window=window, steps=steps,
                           kernels=kernels, ops=[], model_flops=0, peaks=None,
                           memory={})


def _read(name, view):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(view)


def _step(t0=0.0):
    """One step's spans, launch calls and device operations from ``t0`` on
    (seconds): a forward with a dropout inside it, a backward whose
    adjoint span (on the autograd thread) holds a K1 launch and a copy,
    the optimizer, and the report's copy to the host. The device runs
    behind the host, so each operation starts well after its launch."""
    host = [("gab.train_epoch", t0 + 0.0, t0 + 4.0),
            ("gab.forward", t0 + 0.1, t0 + 1.0),
            ("gab.dropout", t0 + 0.2, t0 + 0.4),
            ("gab.backward", t0 + 1.1, t0 + 2.0),
            ("gab.spmm.adjoint", t0 + 1.3, t0 + 1.6),
            ("gab.optimizer", t0 + 2.1, t0 + 2.5),
            ("gab.report", t0 + 2.6, t0 + 3.9),
            ("aten::mm", t0 + 0.5, t0 + 0.7)]
    launches = [("cudaLaunchKernel", 0.25, "philox"),         # dropout
                ("cudaLaunchKernel", 0.30, "where"),          # dropout
                ("cudaLaunchKernelExC", 0.55, "sm80_xmma_gemm"),  # forward
                ("cudaLaunchKernel", 0.80, K1),               # forward
                ("cudaLaunchKernel", 1.20, "where_backward"),  # backward
                ("cudaLaunchKernel", 1.40, K1),               # adjoint
                ("cudaMemcpyAsync", 1.50, "Memcpy DtoD"),     # adjoint
                ("cuLaunchKernelEx", 1.80, "splitKreduce"),   # backward
                ("cudaMemsetAsync", 2.20, "Memset"),          # optimizer
                ("cudaLaunchKernel", 2.30, "adam"),           # optimizer
                ("cudaMemcpyAsync", 2.70, "Memcpy DtoH")]     # report
    dur = {"philox": 0.01, "where": 0.02, "sm80_xmma_gemm": 0.1, K1: 0.2,
           "where_backward": 0.03, "Memcpy DtoD": 0.04, "splitKreduce": 0.05,
           "Memset": 0.001, "adam": 0.002, "Memcpy DtoH": 0.003}
    device, at = [], t0 + 0.35
    for _, s, kernel in launches:
        at = max(at, t0 + s + 0.01)
        device.append((kernel, at, at + dur[kernel]))
        at += dur[kernel]
    host += [(n, t0 + s, t0 + s + 0.005) for n, s, _ in launches]
    host.append(("cudaStreamSynchronize", t0 + 2.71, t0 + 3.8))
    return device, host


def test_pairing_by_launch_order():
    """Two kernels queued behind a third: each is its launch call's by
    order, though both start after both calls."""
    device = [("gemm_a", 3.0, 3.5), ("gemm_b", 3.5, 3.7), ("gemm_c", 3.7, 3.8)]
    host = [("gab.train_epoch", 0.4, 6.0),
            ("gab.forward", 0.5, 2.0), ("gab.backward", 2.2, 2.9),
            ("gab.optimizer", 2.95, 4.0),
            ("cudaLaunchKernel", 1.0, 1.1), ("cudaLaunchKernel", 2.5, 2.6),
            ("cudaLaunchKernel", 2.97, 2.98)]
    v = _view(device, host)
    assert spans.owners(v)[0] == ["gab.forward", "gab.backward",
                                  "gab.optimizer"]
    assert _read("fwd.ms_per_step", v) == pytest.approx(500.0)
    assert _read("bwd.ms_per_step", v) == pytest.approx(200.0)
    assert _read("opt.ms_per_step", v) == pytest.approx(100.0)


def test_innermost_span_wins_across_threads():
    device, host = _step()
    v = _view(device, host)
    own = spans.owners(v)[0]
    assert own[:2] == ["gab.dropout"] * 2 and own[5:7] == ["gab.spmm.adjoint"] * 2
    assert spans.owners(v, spans.PHASES)[0][5:7] == ["gab.backward"] * 2
    assert _read("dropout.ms_per_step", v) == pytest.approx(1e3 * 0.03)
    assert _read("fwd.ms_per_step", v) == pytest.approx(1e3 * 0.3)
    # the adjoint's K1 alone; its copy and K1 both count in the backward
    assert _read("k1.adjoint_ms_per_step", v) == pytest.approx(1e3 * 0.2)
    assert _read("bwd.ms_per_step", v) == pytest.approx(
        1e3 * (0.03 + 0.2 + 0.04 + 0.05))
    assert _read("opt.ms_per_step", v) == pytest.approx(1e3 * 0.003)


def _two_steps():
    d0, h0 = _step(0.0)
    d1, h1 = _step(4.0)
    return d0 + d1, h0 + h1


def _fault(device, host, fault, t0):
    """The trace of ``_two_steps`` with one fault in the step from ``t0``."""
    if fault == "missing_launch":
        host = [h for h in host if h != ("cudaMemsetAsync", t0 + 2.2,
                                         t0 + 2.205)]
    elif fault == "extra_launch":
        host = host + [("cudaLaunchKernel", t0 + 1.25, t0 + 1.26)]
    elif fault == "kinds_differ":
        host = [("cudaLaunchKernel",) + h[1:]
                if h == ("cudaMemsetAsync", t0 + 2.2, t0 + 2.205) else h
                for h in host]
    elif fault == "lost_op":    # a record the trace dropped
        device = [d for d in device if d[0] != "adam" or d[1] < t0
                  or d[1] > t0 + 4]
    return device, host


FAULTS = ["missing_launch", "extra_launch", "kinds_differ", "lost_op"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_every_step_gives_none(fault):
    device, host = _two_steps()
    for t0 in (0.0, 4.0):
        device, host = _fault(device, host, fault, t0)
    v = _view(device, host, steps=2, window=(0.0, 8.0))
    assert spans.paired(v) is None
    assert all(_read(r, v) is None for r in READERS)


@pytest.mark.parametrize("fault", FAULTS + ["window_cut",
                                   "window_takes_the_step_before"])
@pytest.mark.parametrize("faulty", [0, 1])
def test_a_fault_leaves_its_step_out(fault, faulty):
    """One step's pairs do not hold (a launch call or an operation missing
    or extra, or the window cut off that step's first or last operations,
    its device timestamps read early or late): the readers keep the other
    step, paired from the window's other end."""
    device, host = _two_steps()
    if fault == "window_cut":
        device = device[3:] if faulty == 0 else device[:-3]
    elif fault == "window_takes_the_step_before":
        # the device's timestamps read late: the last operations of the
        # step before the window fall inside it, and its last step's out
        device = [("Memcpy DtoH", -0.3, -0.29)] + device[:-1]
    else:
        device, host = _fault(device, host, fault, 4.0 * faulty)
    v = _view(device, host, steps=2, window=(0.0, 8.0))
    assert spans.paired(v)[2] == 1
    sound = _view(*_step(4.0 * (1 - faulty)), window=(0.0, 8.0))
    for r in READERS:
        assert _read(r, v) == pytest.approx(_read(r, sound))


def test_the_device_clock_drifting_from_the_host_keeps_the_pairing():
    """The device's timestamps read 0.2 s early against the host's and
    drift by 100 us more a second: operations read as starting before
    their launch calls, and the pairing, by order and kind, stands."""
    device, host = _two_steps()
    drifted = [(n, s - 1e-4 * s - 0.2, e - 1e-4 * s - 0.2) for n, s, e in device]
    v = _view(drifted, host, steps=2, window=(0.0, 8.0))
    assert any(d[1] < s for d, s in zip(v.device_ops, spans.paired(v)[0]))
    base = _view(device, host, steps=2, window=(0.0, 8.0))
    for r in READERS:
        assert _read(r, v) == pytest.approx(_read(r, base), rel=1e-3)


def test_phases_sum_to_the_device_time():
    device, host = _two_steps()
    v = _view(device, host, steps=2, window=(0.0, 8.0))
    total = sum(_read(r, v) for r in READERS[:4])
    report = spans.phase_ms_per_step(v, "gab.report")
    assert report == pytest.approx(1e3 * 0.003)
    assert (total + report) * v.steps / 1e3 == pytest.approx(v.device_s())
    assert None not in spans.seconds_by_span(v, spans.PHASES)[0]


def test_a_trace_without_the_program_spans_reads_none():
    """The parent's program has no spans: every reader returns None and
    raises nothing. A step that draws no dropout mask (SAGE) reads 0 ms of
    dropout, its forward whole."""
    device, host = _step()
    bare = [h for h in host if not h[0].startswith("gab.")]
    v = _view(device, bare)
    assert spans.owners(v) is None
    assert all(_read(r, v) is None for r in READERS)
    no_drop = [h for h in host if h[0] != "gab.dropout"]
    v = _view(device, no_drop)
    assert _read("dropout.ms_per_step", v) == 0.0
    assert _read("fwd.ms_per_step", v) == pytest.approx(1e3 * 0.33)
    assert _read("bwd.ms_per_step", v) is not None
    assert _read("fwd.ms_per_step", _view([], [])) is None


def test_summary_splits_phases_and_idle_time():
    """``spans.py``'s line of a window: the phases hold all the paired
    device time, drifted operations are counted, and the idle time splits
    into what lies inside the program's steps and what lies between them."""
    device, host = _two_steps()
    v = _view(device, host, steps=2, window=(0.0, 8.0))
    out = spans.summary(v)
    assert out["paired_steps"] == 2 and out["ops_before_their_launch"] == 0
    assert out["launch_calls"] == out["device_ops"] == 22
    assert out["phases_share_of_paired"] == pytest.approx(100.0)
    assert sum(out["phase_ms_per_step"].values()) == pytest.approx(
        out["device_ms_per_step"])
    assert out["span_ms_per_step"]["gab.spmm.adjoint"] == pytest.approx(240.0)
    idle = out["idle_ms_per_step"]
    # each step's span ends at 4 s of its 4: no idle time lies between them
    assert idle["outside"] == pytest.approx(0.0, abs=1e-9)
    assert idle["in_program_steps"] == pytest.approx(
        1e3 * (v.window_s - v.busy_s) / 2)
    assert out["idle_gaps"]
    late = _view(device, host, steps=2, window=(-1.0, 8.0))
    assert spans.summary(late)["idle_ms_per_step"]["outside"] == \
        pytest.approx(500.0)
    drifted = _view([(n, s - 1.0, e - 1.0) for n, s, e in device], host,
                    steps=2, window=(-1.0, 8.0))
    assert spans.summary(drifted)["ops_before_their_launch"] > 0
