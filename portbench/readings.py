"""The readings that a cell's limits are set from (not run by the benchmark's
runs).

    python3 portbench/readings.py --workload <cell> --program-seeds 1,2,...
        [--control-seeds 7,8,9] [--out chiprun_out/readings.jsonl]

For each program seed: the program's set-up and first steps, exactly as a
run makes them, then the reference's, and the numbers of
``reference/check.py`` (the lower readings: sound runs). For each control
seed, with the program put aside: the reference computed with TF32 GEMMs in
the program's place (the control: the precision below the configuration's
float32), and for a training cell the reference with half of the training
vertices left out and the mean taken over the rest (a fault), each against
the float32 reference (the upper readings). A step that leaves the state
unchanged reads 1 on ``grad_gap`` and ``change_gap`` by their definition and
needs no run. One JSON line a reading; the graph is made once.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402
from portbench.reference import check  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def program_reading(cell, row_ptr, col_idx, seed: int, device) -> dict:
    prog, first = harness.set_up(cell, row_ptr, col_idx, seed, device)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return harness.reference_numbers(cell, row_ptr, col_idx, seed, device,
                                     first)


def control_readings(cell, row_ptr, col_idx, seed: int, device) -> dict:
    """{"control": numbers, "half_batch": numbers} against the float32
    reference from the same seed."""
    cfg, mix = cell.cfg, cell.mix
    arch = ref.arch_module(cfg["model"]["arch"])
    inputs = make_inputs(cfg, arch, len(row_ptr) - 1, seed, device)
    graph = ref.RefGraph.build(row_ptr, col_idx, arch, device)
    if mix["step"] != "train":
        rows = torch.arange(cfg["train_nodes"], graph.nv, device=device)
        acc = {p: ref.eval_accuracy(cfg, graph, inputs.feats, inputs.labels,
                                    inputs.weights, rows, p)
               for p in ("float32", "tf32")}
        return {"control": {"acc_gap": abs(acc["tf32"] - acc["float32"])}}

    def traj(**kw):
        return ref.train_steps(cfg, graph, inputs.feats, inputs.labels,
                               inputs.weights, inputs.dropout_seed,
                               mix["checked_steps"], **kw)

    base = traj()
    out = {}
    for name, kw in (("control", {"precision": "tf32"}),
                     ("half_batch", {"rows": torch.arange(
                         0, cfg["train_nodes"], 2, device=device)})):
        t = traj(**kw)
        out[name] = check.training_numbers(t.losses, t.grad1, t.w_after, base)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: no readings on the CPU", file=sys.stderr)
        return 3
    device = torch.device("cuda")
    cell = harness.Cell.load(args.workload, ROOT)
    row_ptr, col_idx = harness.cell_graph(cell, device)
    out = open(args.out, "a") if args.out else None
    seeds = [("program", s) for s in args.program_seeds.split(",") if s]
    seeds += [("control", s) for s in args.control_seeds.split(",") if s]
    for kind, s in seeds:
        t = time.perf_counter()
        fn = program_reading if kind == "program" else control_readings
        numbers = fn(cell, row_ptr, col_idx, int(s), device)
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": int(s), "numbers": numbers,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
