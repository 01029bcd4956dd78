"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It makes the cell's graph and the seed's
inputs, sets up the port's ``Model``, runs its first steps (checked later
against the plain reference) and measures ``--seconds`` of steps back to
back; with ``--trace 1`` it traces some of them under ``torch.profiler``
and reports the per-layer metrics in place of the end-to-end ones. Then it
frees the program, runs the reference and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), and last
``checks``, each number compared beside its limit; the same numbers are
the last lines of its standard error.

It needs the CUDA cards the cell asks for and never falls back to the CPU:
without them it prints no result and exits with 3. It exits with 4 and no
result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "cache"
# the kernel caches of the libraries the program could use, at fixed paths
# of the checkout (the port builds its own kernels into build/ of it)
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import portbench.program  # noqa: F401  (the system under test, or stop)

    chips = harness.Cell.load(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA card(s), this machine has {n}: "
              "no run on the CPU", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda", STARTED, ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
