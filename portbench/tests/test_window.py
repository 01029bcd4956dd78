"""The end-to-end readers on synthetic windows: a stall moves them."""

from __future__ import annotations

import itertools

import pytest

from portbench import harness


def _read(name, bounds, group=2):
    w = harness.WindowView(bounds=bounds, group_steps=group, setup_s=12.5,
                           memory_peak_bytes=3 * 2**30)
    return harness.load_module(
        harness.HERE / "end_to_end" / f"{name}.py").read(w)


def _bounds(steps):
    return list(itertools.accumulate(steps, initial=100.0))


def test_steady_window():
    b = _bounds([0.136] * 200)
    assert _read("step_ms", b) == pytest.approx(136.0)
    assert _read("step_ms_p90", b) == pytest.approx(136.0)
    assert _read("setup_s", b) == 12.5
    assert _read("peak_mem_gib", b) == 3.0


def test_one_long_stall_moves_the_mean():
    steps = [0.136] * 200
    steps[57] += 2.0
    b = _bounds(steps)
    assert _read("step_ms", b) == pytest.approx(136.0 + 2000.0 / 200)
    assert _read("step_ms_p90", b) == pytest.approx(136.0)


def test_a_slow_step_every_eighth_moves_the_tail():
    steps = [0.136 + (0.030 if i % 8 == 3 else 0.0) for i in range(200)]
    b = _bounds(steps)
    assert _read("step_ms_p90", b) == pytest.approx(136.0 + 30.0 / 2)
    assert _read("step_ms", b) == pytest.approx(136.0 + 30.0 / 8)


def test_tail_groups_cover_the_window():
    steps = [0.1 * (i + 1) for i in range(10)]
    b = _bounds(steps)
    # five groups of two; the nearest-rank 90th percentile is the fifth
    assert _read("step_ms_p90", b) == pytest.approx(1e3 * (0.9 + 1.0) / 2)
