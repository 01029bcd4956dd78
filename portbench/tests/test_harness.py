"""The harness finds a cell's configuration, mix, limits, readers and
kernels by name, and takes new ones as files alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

from conftest import REPO, shrink

from portbench import harness


def test_cell_resolves_every_file_by_name(tiny_root):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.Cell.load(w["name"], tiny_root)
        assert cell.mix["step"] == "train"
        assert set(cell.limits) <= {"loss_gap", "loss1_gap", "grad_gap",
                                    "change_gap"}
        assert {m["name"] for m in cell.end_to_end} == {
            m["name"] for m in bench["end_to_end"]}
        assert {m["name"] for m in cell.per_layer} == {
            m["name"] for m in bench["per_layer"]}
        for m in cell.end_to_end:
            assert callable(harness.load_module(
                harness.HERE / "end_to_end" / f"{m['name']}.py").read)
        for m in cell.per_layer:
            assert callable(harness.load_module(
                harness.HERE / "metrics" / f"{m['name']}.py").read)
    for k in ("k1", "gemm"):
        mod = harness.load_module(harness.HERE / "kernels" / f"{k}.py")
        assert mod.PATTERN and callable(mod.work)


def test_run_on_the_cpu_gives_the_contract_keys(tiny_root):
    for traced in (False, True):
        res, lines = harness.run_cell("sage-products.train", 2**31 + 17, 0.2,
                                      traced, "cpu", time.perf_counter(),
                                      tiny_root)
        assert list(res) == (["correct", "attempted", "failed", "metrics",
                              "device"] + (["breakdown"] if traced else [])
                             + ["checks"])
        assert res["correct"] is True and res["failed"] == 0
        assert res["attempted"] % 2 == 0
        if traced:
            assert res["attempted"] >= 32      # the traced steps are whole
            assert {"busy_s", "window_s"} <= set(res["device"])
        else:
            assert set(res["metrics"]) == {"step_ms", "step_ms_p90",
                                           "peak_mem_gib", "setup_s"}
        assert [ln.split(":")[0] for ln in lines] == [
            "check loss_gap", "check loss1_gap", "check grad_gap",
            "check change_gap"]


NEW_METRIC = '''
def read(t):
    return float(t.steps) if "probe" in t.kernels else None
'''

NEW_KERNEL = '''
PATTERN = r"relu|clamp"


def work(op):
    return None
'''


def test_new_config_mix_metric_and_kernel_are_files_alone(tmp_path):
    """A copy of the checkout gets a new configuration, a new mix (full-graph
    inference), its limits, a new per-layer reader and a new kernel file,
    and entries in BENCHMARK.json; the copy's harness, unedited, runs the
    new cell and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "gcn-products.json").read_text())
    cfg["model"]["dim_hid"] = 64
    (pb / "configs" / "gcn-narrow.json").write_text(json.dumps(cfg))
    (pb / "mixes" / "infer.json").write_text(json.dumps({
        "step": "evaluate", "checked_steps": 2, "tail_group_steps": 2,
        "trace_warmup_steps": 1, "trace_steps": 4}))
    (pb / "limits" / "gcn-narrow.infer.json").write_text('{"acc_gap": 0.01}')
    (pb / "metrics" / "probe.steps.py").write_text(NEW_METRIC)
    (pb / "kernels" / "probe.py").write_text(NEW_KERNEL)
    bench["configs"].append({**bench["configs"][0], "name": "gcn-narrow",
                             "file": "portbench/configs/gcn-narrow.json"})
    bench["workloads"].append({"name": "gcn-narrow.infer", "config": "gcn-narrow",
                               "traffic": "infer", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "probe.steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "Model loop", "moves": "step_ms",
                               "workloads": ["gcn-narrow.infer"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shrink(root)
    script = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "assert harness.HERE == Path(sys.path[0]) / 'portbench'\n"
        "out = []\n"
        "for traced in (False, True):\n"
        "    res, _ = harness.run_cell('gcn-narrow.infer', 5, 0.2, traced,\n"
        f"                              'cpu', time.perf_counter(), Path({str(root)!r}))\n"
        "    out.append(res)\n"
        "print(json.dumps(out))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced = json.loads(p.stdout.strip().splitlines()[-1])
    assert plain["correct"] and set(plain["checks"]) == {"acc_gap"}
    assert set(plain["metrics"]) == {"step_ms", "step_ms_p90", "peak_mem_gib",
                                     "setup_s"}
    assert traced["metrics"]["probe.steps"] == {"value": 4.0, "unit": "steps"}
