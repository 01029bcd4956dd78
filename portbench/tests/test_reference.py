"""The plain reference against the port's CPU path, and the import rules."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import REPO

from portbench import harness


@pytest.mark.parametrize("workload", ["gcn-products.train",
                                      "sage-products.train"])
def test_reference_follows_the_ports_cpu_path(tiny_root, workload):
    """Three steps of the port's Model on the CPU (its plain kernels) against
    the reference's from the same seed: the loss of each step, the first
    gradient and the change agree to float32 rounding."""
    cell = harness.Cell.load(workload, tiny_root)
    dev = torch.device("cpu")
    rp, ci = harness.cell_graph(cell, dev)
    prog, first = harness.set_up(cell, rp, ci, 2**31 + 99, dev)
    assert len(first["values"]) == 3
    assert len(set(first["values"])) == 3      # the steps moved the weights
    numbers = harness.reference_numbers(cell, rp, ci, 2**31 + 99, dev, first)
    assert set(numbers) == {"loss_gap", "loss1_gap", "grad_gap", "change_gap"}
    assert max(numbers.values()) < 1e-6, numbers


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("graphaibench_tpu_torch", "graphaibench_tpu_torch.nn",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "graphaibench_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["graphaibench_tpu", "jax"]


def _top_level_modules(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
         + code + "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    """Everything a run loads, the program and a whole run on the CPU
    included, by whole top-level names."""
    mods = _top_level_modules(
        "import time\nfrom pathlib import Path\n"
        "from portbench import graphgen, harness, readings\n"
        f"graphgen.CACHE_DIR = Path({str(tiny_root.parent / 'graphs')!r})\n"
        "harness.run_cell('gcn-products.train', 3, 0.1, True, 'cpu',\n"
        f"                 time.perf_counter(), Path({str(tiny_root)!r}))")
    assert "graphaibench_tpu_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "graphaibench_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    mods = _top_level_modules(
        "from portbench.reference import check, gcn, model, sage\n"
        "from portbench import graphgen, inputs, workmodel, trace, peaks")
    assert not mods & {"jax", "jaxlib", "flax", "graphaibench_tpu",
                       "graphaibench_tpu_torch"}


def test_no_card_no_run():
    """Without a CUDA card the benchmark prints no result and exits with 3:
    it never falls back to the CPU."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "gcn-products.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, timeout=300, cwd=REPO)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "no run on the CPU" in p.stderr
