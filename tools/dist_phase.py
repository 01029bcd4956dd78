#!/usr/bin/env python3
"""chip_smoke.py's dist_analytics phase alone, on one CUDA card.

Run from the root of a checkout (``PYTHONPATH=.``), on a machine with a
card:

    python3 tools/dist_phase.py [--kernel]

Prints the card (nvidia-smi name and power limit), builds the kernels,
generates chip_smoke's analytics graph (rmat(19, 16) seed 0, symmetric)
and runs ``chip_smoke.phase_dist_analytics`` on it: the distributed
solvers at one nccl rank and at two gloo ranks on the card, the 2-D
count's 2 x 2 blocks, K8 and K1 at F = 1 on the rank tables, with every
check of that phase. ``--kernel`` first runs chip_smoke's K1 phase on
rmat(17, 16) (every instantiation of K1 held to its plain version).
Exits with another code than 0 where a check fails.
"""

from __future__ import annotations

import argparse
import time

import chip_smoke as cs
from graphaibench_tpu_torch import rmat
from graphaibench_tpu_torch.ops.device_graph import to_device_graph


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="store_true",
                    help="run chip_smoke's K1 phase on rmat17 first")
    args = ap.parse_args()
    cs.phase_device()
    cs._timed("build", cs.phase_build)
    if args.kernel:
        cs._timed("kernel K1", cs.phase_kernel,
                  rmat(cs.SCALE, cs.EDGE_FACTOR, seed=0))
    t0 = time.perf_counter()
    g = rmat(cs.ANALYTICS_SCALE, cs.EDGE_FACTOR, seed=0)
    dg = to_device_graph(g, device="cuda")
    print(f"[graph] rmat({cs.ANALYTICS_SCALE}, {cs.EDGE_FACTOR}) in "
          f"{time.perf_counter() - t0:.2f} s")
    cs._timed("dist_analytics", cs.phase_dist_analytics, g, dg)


if __name__ == "__main__":
    main()
