#!/usr/bin/env python3
"""Drive ``chip_smoke.py``'s triangle-counting, k-core and betweenness
phases, and its seven CLI runs, on one CUDA card at a chosen rmat scale:

    python3 tools/analytics_probe.py [--scale 17]

Builds every kernel (``chip_smoke.phase_build``, with the register
report), generates rmat(scale, 16, seed=0), then runs ``phase_tc`` (K9
against its plain version, ``triangle_count`` against scipy, cold and warm
seconds, device ms beside the bound), ``phase_kcore`` (K10 against its
plain version, ``k_core_hindex`` and ``k_core_peel`` against the serial
oracle, sweeps and launches), ``phase_bc`` (against a float64 Brandes, one
K8 launch a level) and ``phase_analytics_cli``, each timed; a phase that
fails prints its traceback and the next one runs. The exit code is 1 if any
phase failed. A quicker look at the analytics' new kernels than the whole
``chip_smoke.py``; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from graphaibench_tpu_torch import rmat  # noqa: E402
from graphaibench_tpu_torch.ops.device_graph import to_device_graph  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=17)
    scale = ap.parse_args().scale
    C.ANALYTICS_SCALE = scale
    C.phase_device()
    C.phase_build()
    t0 = time.perf_counter()
    g = rmat(scale, C.EDGE_FACTOR, seed=0)
    dg = to_device_graph(g, device="cuda")
    print(f"graph in {time.perf_counter() - t0:.2f} s")
    failed = []
    for name, fn in (("tc", lambda: C.phase_tc(g)),
                     ("kcore", lambda: C.phase_kcore(g, dg)),
                     ("bc", lambda: C.phase_bc(g, dg)),
                     ("cli", C.phase_analytics_cli)):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report every phase, then fail
            traceback.print_exc()
            print(f"PHASE {name} FAILED: {e!r}")
            failed.append(name)
        print(f"phase {name} {time.perf_counter() - t0:.2f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
