#!/usr/bin/env python3
"""chip_smoke.py's remat and p15a phases alone, on one CUDA card.

Run from the root of a checkout (``PYTHONPATH=.``), on a machine with a
card:

    python3 tools/p15a_phase.py

Prints the card (nvidia-smi name and power limit) and builds the kernels;
then ``chip_smoke.phase_remat`` on rmat(17, 16) seed 0 (``cfg.remat``'s
gradients held to the plain ones at dropout, its launches a step and its
peak memory) and ``chip_smoke.phase_p15a`` on chip_smoke's analytics graph,
rmat(19, 16) seed 0 symmetric (K14 against its plain version, timed beside
its bound; color, cf_train, boruvka_mst, the samplers, deepwalk, node2vec,
knn_search and their CLI routes), with every check of those phases. Exits
with another code than 0 where a check fails.
"""

from __future__ import annotations

import time

import chip_smoke as cs
from graphaibench_tpu_torch import rmat
from graphaibench_tpu_torch.ops.device_graph import to_device_graph


def main() -> None:
    cs.phase_device()
    cs._timed("build", cs.phase_build)
    cs._timed("remat", cs.phase_remat, rmat(cs.SCALE, cs.EDGE_FACTOR, seed=0))
    t0 = time.perf_counter()
    g = rmat(cs.ANALYTICS_SCALE, cs.EDGE_FACTOR, seed=0)
    dg = to_device_graph(g, device="cuda")
    print(f"[graph] rmat({cs.ANALYTICS_SCALE}, {cs.EDGE_FACTOR}) in "
          f"{time.perf_counter() - t0:.2f} s")
    cs._timed("p15a", cs.phase_p15a, g, dg)


if __name__ == "__main__":
    main()
