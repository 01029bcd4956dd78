"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the trace, and the check that decides ``correct``.

Everything that belongs to one configuration, mix, metric or kernel is a
file the harness finds by its name:

* ``BENCHMARK.json`` (the checkout's root): the cell, its configuration's
  file and its metrics;
* ``portbench/mixes/<traffic>.json``: what a step is (``"train"``, a
  full-batch training step, or ``"evaluate"``, a full-graph inference pass),
  how many first steps are checked, the steps to a tail group, and the
  steps traced;
* ``portbench/limits/<workload>.json``: the limit of each number compared;
* ``portbench/reference/<arch>.py``: the architecture's plain reference;
* ``portbench/end_to_end/<metric>.py`` and ``portbench/metrics/<metric>.py``:
  a reader each, of the window and of the trace;
* ``portbench/kernels/<kernel>.py``: a kernel's name pattern and its work.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import graphgen, trace, workmodel
from portbench.inputs import layer_dims, make_inputs
from portbench.peaks import PEAKS
from portbench.reference import check
from portbench.reference import model as ref

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "graphaibench_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A reader or kernel file, loaded by its path (its name may hold dots)."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything its name leads to."""

    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, workload: str, root: Path) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        w = _named(bench["workloads"], workload, "workload")
        conf = _named(bench["configs"], w["config"], "configuration")

        def mine(m):
            return workload in m.get("workloads", [workload])
        return cls(name=workload, chips=w["chips"],
                   cfg=load_json(root / conf["file"]),
                   mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"),
                   limits=load_json(HERE / "limits" / f"{workload}.json"),
                   end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                   per_layer=[m for m in bench["per_layer"] if mine(m)])


@dataclasses.dataclass
class WindowView:
    """What the end-to-end readers take: the step boundaries on the host's
    clock (``bounds[i]`` ends step i and starts step i + 1), the set-up
    seconds and the memory peak."""

    bounds: list
    group_steps: int
    setup_s: float
    memory_peak_bytes: int


def first_steps(prog, mix: dict) -> dict:
    """The program's first steps, through the window's own call: what each
    step reports and, for training, the first gradient as the optimizer got
    it and the weights after the last."""
    kind, n = mix["step"], mix["checked_steps"]
    out = {"values": [], "grad1": None, "w_after": None}
    for i in range(n):
        out["values"].append(prog.step(kind))
        if kind == "train" and i == 0:
            out["grad1"] = prog.first_gradient()
    if kind == "train":
        out["w_after"] = prog.weights()
    return out


def reference_numbers(cell: Cell, row_ptr, col_idx, seed: int, device,
                      first: dict) -> dict:
    """The numbers of ``reference/check.py``: the program's first steps
    against the reference's from the same seed's inputs."""
    cfg, mix = cell.cfg, cell.mix
    arch = ref.arch_module(cfg["model"]["arch"])
    inputs = make_inputs(cfg, arch, len(row_ptr) - 1, seed, device)
    graph = ref.RefGraph.build(row_ptr, col_idx, arch, device)
    if mix["step"] == "train":
        traj = ref.train_steps(cfg, graph, inputs.feats, inputs.labels,
                               inputs.weights, inputs.dropout_seed,
                               mix["checked_steps"])
        return check.training_numbers(first["values"], first["grad1"],
                                      first["w_after"], traj)
    rows = torch.arange(cfg["train_nodes"], graph.nv, device=device)
    acc = ref.eval_accuracy(cfg, graph, inputs.feats, inputs.labels,
                            inputs.weights, rows)
    return {"acc_gap": max(abs(v - acc) for v in first["values"])}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_graph(cell: Cell, device) -> tuple:
    """The configuration's graph as (row_ptr, col_idx), checked against the
    sizes its file states."""
    cfg = cell.cfg
    row_ptr, col_idx = graphgen.make_graph(cfg["graph"], device)
    nv, ne = len(row_ptr) - 1, len(col_idx)
    if (nv, ne) != (cfg["num_nodes"], cfg["num_edges"]):
        raise RuntimeError(f"graph has {nv} vertices and {ne} edges, the "
                           f"configuration states {cfg['num_nodes']} and "
                           f"{cfg['num_edges']}")
    return row_ptr, col_idx


def set_up(cell: Cell, row_ptr, col_idx, seed: int, device,
           stages: dict | None = None):
    """The program on the seed's inputs, its allocator's peak counted from
    its own set-up on, and its first steps: (program, first_steps' dict).
    ``stages`` gets the seconds of each part."""
    from portbench.program import Program

    stages = {} if stages is None else stages
    t = time.perf_counter()
    cfg = cell.cfg
    arch = ref.arch_module(cfg["model"]["arch"])
    inputs = make_inputs(cfg, arch, len(row_ptr) - 1, seed, device)
    feats, labels = inputs.feats.cpu().numpy(), inputs.labels.cpu().numpy()
    weights, dropout_seed = inputs.weights, inputs.dropout_seed
    del inputs
    if device.type == "cuda":    # the peak from here on is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    stages["inputs"], t = time.perf_counter() - t, time.perf_counter()
    prog = Program(cfg, row_ptr, col_idx, feats, labels, weights,
                   dropout_seed, device)
    del feats, labels, weights
    stages["program"], t = time.perf_counter() - t, time.perf_counter()
    first = first_steps(prog, cell.mix)
    _sync(device)
    stages["first_steps"] = time.perf_counter() - t
    return prog, first


def _profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def window(prog, mix: dict, seconds: float, traced: bool) -> tuple:
    """Steps back to back until ``seconds`` have passed and the last tail
    group is whole; traced, the ``trace_steps`` after the first
    ``trace_warmup_steps`` run under the profiler, and the window lasts until
    they have. The profiler starts a step early: the device's first events
    after a start can be lost, and that step is left out of the trace.
    Returns (what each step reported, the step boundaries on the host's
    clock, the stopped profiler or None)."""
    kind, group = mix["step"], mix["tail_group_steps"]
    warm, active = mix["trace_warmup_steps"], mix["trace_steps"]
    values, bounds, prof, done = [], [time.perf_counter()], None, None
    while True:
        if traced and len(values) == warm - 1 and done is None:
            prof = _profiler()
            prof.start()
        with torch.profiler.record_function(trace.STEP_SPAN):
            values.append(prog.step(kind))
        bounds.append(time.perf_counter())
        if prof is not None and len(values) == warm + active:
            prof.stop()
            done, prof = prof, None
        if (bounds[-1] - bounds[0] >= seconds and len(values) % group == 0
                and (done is not None or not traced)):
            return values, bounds, done


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, started: float, root: Path) -> tuple[dict, list[str]]:
    """One run: returns the result object and the lines of the numbers
    compared, each beside its limit."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    card = torch.cuda.get_device_name(device) if cuda else device.type
    cell = Cell.load(workload, root)
    cfg, mix = cell.cfg, cell.mix
    arch = ref.arch_module(cfg["model"]["arch"])
    t = time.perf_counter()
    stages = {"imports_and_cuda": t - started}
    row_ptr, col_idx = cell_graph(cell, device)
    nv, ne = len(row_ptr) - 1, len(col_idx)
    stages["graph"] = time.perf_counter() - t
    prog, first = set_up(cell, row_ptr, col_idx, seed, device, stages)
    if traced:    # the profiler's first start takes seconds: not in the window
        t = time.perf_counter()
        with _profiler():
            _sync(device)
        stages["profiler"] = time.perf_counter() - t
    setup_s = time.perf_counter() - started
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in stages.items()),
          file=sys.stderr, flush=True)
    held = torch.cuda.memory_allocated(device) if cuda else 0
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    values, bounds, done = window(prog, mix, seconds, traced)
    kind, group = mix["step"], mix["tail_group_steps"]
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory_peak = max(setup_peak, window_peak)

    if traced:
        ops = arch.step_ops(layer_dims(cfg), nv, ne, train=kind == "train")
        kernels = {p.stem: load_module(p)
                   for p in sorted((HERE / "kernels").glob("*.py"))}
        view = trace.from_profiler(
            done, kernels=kernels, ops=ops,
            model_flops=workmodel.model_flops(ops), peaks=PEAKS.get(card),
            memory={"held_bytes": held,
                    "window_peak_bytes": window_peak if cuda else None})
        readers = cell.per_layer
        source = view
    else:
        readers = cell.end_to_end
        source = WindowView(bounds, group, setup_s, memory_peak)
    metrics = {}
    for m in readers:
        sub = "metrics" if traced else "end_to_end"
        v = load_module(HERE / sub / f"{m['name']}.py").read(source)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else device.type, "kind": card,
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power_limit"] = _power_limit()
    if traced:
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s

    del prog, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = reference_numbers(cell, row_ptr, col_idx, seed, device, first)
    correct, checks = check.judge(numbers, cell.limits)
    failed = sum(1 for v in values if not math.isfinite(v))
    result = {"correct": correct and failed == 0, "attempted": len(values),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = view.breakdown()
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return result, lines
