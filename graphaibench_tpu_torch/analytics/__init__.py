"""Graph analytics solvers of the port, each paired with a serial oracle
in ``verifiers.py`` (the reference's verifier pattern); ``run_benchmark``
prints Correct/Wrong like the reference binaries' main.cc.

Counterpart of ``graphaibench_tpu/analytics/``: the pull-mode solvers BFS,
SSSP, PageRank and CC, whose sweeps run the kernel ``neighbor_reduce``
(``ops/ell_pull.py``) on a CUDA graph. The other solvers (``tc``,
``kcore``, ``bc``: ROADMAP P12b; the rest: P15), the compressed-graph
prefixes (P13a) and ``GAB_SHARDS`` (P14b) are not ported yet: asked for,
``run_benchmark`` exits with code 2 and names the item.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from graphaibench_tpu_torch.analytics import verifiers  # noqa: F401
from graphaibench_tpu_torch.analytics.cc import (  # noqa: F401
    connected_components,
    connected_components_afforest,
)
from graphaibench_tpu_torch.analytics.pr import pagerank  # noqa: F401
from graphaibench_tpu_torch.analytics.traversal import (  # noqa: F401
    bfs,
    bfs_frontier,
    bfs_host,
    sssp_bellman_ford,
    sssp_delta_stepping,
)

PORTED = ("bfs", "sssp", "pr", "cc")
# the JAX package's other analytics kernels, by the ROADMAP item that ports
# them
NOT_PORTED = {
    **dict.fromkeys(("tc", "bc", "kcore"), "P12b"),
    **dict.fromkeys(("color", "cf", "motif", "fsm", "embed", "sample"), "P15"),
}


def _refuse(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 2


def run_benchmark(kernel: str, dataset_path: str, args: list[str], *,
                  device="cuda") -> int:
    """The CLI route: load, solve on ``device``, verify, print Correct/Wrong
    and the runtime; the return value is the exit code."""
    import torch

    from graphaibench_tpu_torch.graph.io import load_graph
    from graphaibench_tpu_torch.graph.transforms import is_symmetric
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    if kernel in NOT_PORTED:
        return _refuse(f"analytics {kernel} is not ported yet (ROADMAP "
                       f"queue 1, {NOT_PORTED[kernel]})")
    if kernel not in PORTED:
        print(f"unknown kernel {kernel!r}")
        return 2
    if os.path.exists(dataset_path + ".meta.json"):
        return _refuse("compressed-graph prefixes are not ported yet "
                       "(ROADMAP queue 1, P13a)")
    g = load_graph(dataset_path)
    print(f"|V| {g.nv} |E| {g.ne}")
    if os.environ.get("GAB_SHARDS", ""):
        return _refuse("GAB_SHARDS: the distributed analytics are not "
                       "ported yet (ROADMAP queue 1, P14b)")
    print(f"device = {device}")
    # pull-mode frontier kernels (neighbor_reduce over row buckets) assume
    # a structurally symmetric graph; directed inputs keep the scatter push
    # formulation, which stays correct
    pull_ok = is_symmetric(g)
    if not pull_ok:
        print("directed input: push/scatter kernels (no pull ELL)")
    source = int(args[0]) if args else 0
    t0 = time.perf_counter()

    if kernel == "bfs":
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=pull_ok)
        dist = bfs(dg, source).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"reached = {(dist >= 0).sum()}, max_depth = {dist.max()}")
        ok = np.array_equal(dist, verifiers.bfs_serial(g, source))
    elif kernel == "sssp":
        w = (np.asarray(g.elabels, dtype=np.float32)
             if g.elabels is not None else np.ones(g.ne, np.float32))
        # the pull gathers each slot's REVERSE-edge weight through
        # trans_perm, so the transpose permutation rides along whenever
        # the pull is taken
        dg = to_device_graph(g, device=device, with_transpose=pull_ok,
                             with_ell=pull_ok)
        dist = sssp_bellman_ford(dg, torch.from_numpy(w).to(device),
                                 source).cpu().numpy()
        dt = time.perf_counter() - t0
        ref = verifiers.dijkstra_serial(g, w, source)
        ok = np.allclose(dist, ref, rtol=1e-5, equal_nan=True)
    elif kernel == "pr":
        dg = to_device_graph(g, device=device, with_transpose=False,
                             with_ell=pull_ok)
        scores, iters = pagerank(dg)
        scores = scores.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"iterations = {iters}")
        ref = verifiers.pagerank_serial(g, g)
        ok = np.allclose(scores, ref, atol=1e-4)
    else:  # cc
        if pull_ok:
            # Afforest sampling shortcut (omp_afforest.cc): first-k link
            # rounds + giant-component contraction; symmetric inputs only
            comp = connected_components_afforest(g, device=device)
        else:
            dg = to_device_graph(g, device=device, with_transpose=False,
                                 with_ell=False)
            comp = connected_components(dg).cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"num_components = {len(np.unique(comp))}")
        ok = np.array_equal(comp, verifiers.cc_serial(g))

    print(f"runtime = {dt:.4f} sec")
    print("Correct" if ok else "Wrong")
    return 0 if ok else 1
