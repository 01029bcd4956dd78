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

``--tc-cold`` times cold ``triangle_count`` solves instead, split into the
host's orientation, the device layout (``ops/tc_count.py::dag_edges``, its
upload included) and the K9 count, each part ending in a sync:

    python3 tools/analytics_probe.py --tc-cold [--parent DIR] [--scale 19]

Each turn is a process of its own that builds K9 alone, makes a cold solve
of rmat(10) first (the first use of the CUDA ops it runs), then
``TC_COLD_SOLVES`` cold solves of the graph, each after the device state's
cache is cleared. With ``--parent DIR`` the turns are parent, change,
change, parent (the change is the checkout this script lies in; make the
parent's with ``git archive <commit> graphaibench_tpu_torch | tar -x -C
build/parent``), on one graph written once. The card's name and power
limit first, then one ``TC_COLD {json}`` line a turn.

``--tc-stream-mem`` reads where ``triangle_count_streaming``'s device
memory goes, on rmat(scale, 16) in CGR's default config:

    python3 tools/analytics_probe.py --tc-stream-mem [--parent DIR] [--scale 19]

Each turn is a process of its own that builds the kernels and takes the
baseline (``torch.cuda.memory_allocated``) with only its CUDA context up,
then reads ``max_memory_allocated`` (reset after each reading, so a
stage's own peak) and ``memory_allocated`` over the baseline after each
stage of one block pair, the first two blocks at the
default ``block_bytes``: ``open_cgr_stream``, ``dag_block`` of I and of J,
``edges_between`` (the pair's local CSR and its edges built as the
streamed count builds them), ``tc_count``; then, everything of the pair
freed and the peak reset, the whole streamed count: its peak, seconds,
blocks, pairs and triangles. The turns are ordered as ``--tc-cold``'s, on
one stream written once; one ``TC_STREAM_MEM {json}`` line a turn, with the
CSR's bytes beside the peaks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC_COLD_SOLVES = 3


def phases(scale: int) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

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


def tc_cold_worker(tree: str, graph_npz: str) -> None:
    """One turn of ``--tc-cold``: cold solves of the checkout at ``tree``
    on the graph in ``graph_npz``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from graphaibench_tpu_torch import CSRGraph, rmat
    from graphaibench_tpu_torch.analytics import tc as TC
    from graphaibench_tpu_torch.graph import transforms as T
    from graphaibench_tpu_torch.ops import _build
    from graphaibench_tpu_torch.ops import tc_count as K9

    import graphaibench_tpu_torch
    assert graphaibench_tpu_torch.__file__.startswith(os.path.abspath(tree))
    t0 = time.perf_counter()
    _build.load_library("tc_count")
    build_s = time.perf_counter() - t0

    def cold(g) -> dict:
        TC._TC_CACHE.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = TC.triangle_count(g, device="cuda")
        t1 = time.perf_counter()
        # the same solve again, by its parts
        dag = T.orientation(g)
        t2 = time.perf_counter()
        state = K9.dag_edges(dag.row_ptr, dag.col_idx, device="cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        m = int(K9.tc_count(state))
        t4 = time.perf_counter()
        assert n == m and dag.has_sorted_neighbors()
        return {"triangles": n, "cold_s": t1 - t0, "orientation_s": t2 - t1,
                "dag_edges_s": t3 - t2, "count_s": t4 - t3}

    cold(rmat(10, 16, seed=0, cache=False))
    z = np.load(graph_npz)
    g = CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"])
    solves = [cold(g) for _ in range(TC_COLD_SOLVES)]
    print("TC_COLD " + json.dumps({"tree": tree, "build_s": build_s,
                                   "solves": solves}))


def tc_stream_mem_worker(tree: str, prefix: str) -> None:
    """One turn of ``--tc-stream-mem``: the stages of one block pair and the
    whole streamed count, with the checkout at ``tree``, on the compressed
    prefix ``prefix``."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from graphaibench_tpu_torch.analytics import tc_stream as TS
    from graphaibench_tpu_torch.compress.cli import load_compressed
    from graphaibench_tpu_torch.ops import _build
    from graphaibench_tpu_torch.ops import tc_count as K9

    import graphaibench_tpu_torch
    assert graphaibench_tpu_torch.__file__.startswith(os.path.abspath(tree))
    _build.load_library("cgr_decode")
    _build.load_library("tc_count")
    cg = load_compressed(prefix)
    csr_bytes = (cg.nv + 1) * 8 + cg.ne * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stages = []

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        stages.append({"stage": name,
                       "peak": torch.cuda.max_memory_allocated() - base,
                       "held": torch.cuda.memory_allocated() - base})
        torch.cuda.reset_peak_memory_stats()

    st = TS.open_cgr_stream(cg, device="cuda")
    mark("open_cgr_stream")
    bounds = TS.block_bounds(st, TS.DEFAULT_BLOCK_BYTES)
    (ilo, ihi), (jlo, jhi) = bounds[0], bounds[1]
    rp_i, col_i, u_i = TS.dag_block(st, ilo, ihi)
    mark("dag_block I")
    rp_j, col_j = TS.dag_block(st, jlo, jhi)[:2]
    mark("dag_block J")
    rp = torch.cat([rp_i, rp_j[1:] + rp_i[-1]])
    col = torch.cat([col_i, col_j])
    del rp_j, col_j
    sel = (col_i >= jlo) & (col_i < jhi)
    src = u_i[sel]
    dst = (col_i[sel] - jlo) + (ihi - ilo)
    del sel
    pair = K9.edges_between(rp, col, src, dst, id_bound=st.nv)
    mark("edges_between")
    n_pair = int(K9.tc_count(pair))
    mark("tc_count")
    del st, rp_i, col_i, u_i, rp, col, src, dst, pair
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n, stats = TS.triangle_count_streaming(cg, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print("TC_STREAM_MEM " + json.dumps({
        "tree": tree, "csr_bytes": csr_bytes, "stream_bytes": len(cg.data),
        "blocks_ij": [[ilo, ihi], [jlo, jhi]], "pair_triangles": n_pair,
        "stages": stages, "triangles": n, "seconds": seconds,
        "peak": torch.cuda.max_memory_allocated() - base, **stats}))


def _turns(parent: str | None, worker: str, path: str, tag: str) -> None:
    """Run ``worker`` on ``path`` with the change alone, or with parent,
    change, change, parent; print each turn's ``tag`` line."""
    order = [("change", ROOT)]
    if parent:
        order = [("parent", parent), ("change", ROOT), ("change", ROOT),
                 ("parent", parent)]
    for name, tree in order:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), worker, tree, path],
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith(tag + " ")]
        if r.returncode != 0 or not lines:
            print(r.stdout[-4000:], r.stderr[-8000:], sep="\n",
                  file=sys.stderr)
            raise SystemExit(f"the {name} turn failed with code "
                             f"{r.returncode}")
        res = json.loads(lines[-1][len(tag) + 1:])
        res["turn"] = name
        print(f"{tag} " + json.dumps(res))
        sys.stdout.flush()


def tc_stream_mem(parent: str | None, scale: int) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat
    from graphaibench_tpu_torch.compress import cgr
    from graphaibench_tpu_torch.compress.cli import save_compressed
    from graphaibench_tpu_torch.graph.transforms import sort_and_clean

    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "g")
        g = sort_and_clean(rmat(scale, 16, seed=0))
        save_compressed(cgr.encode_graph(g, cgr.CgrConfig()), prefix)
        _turns(parent, "--tc-stream-mem-worker", prefix, "TC_STREAM_MEM")


def tc_cold(parent: str | None, scale: int) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat

    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "graph.npz")
        g = rmat(scale, 16, seed=0, cache=False)
        np.savez(npz, row_ptr=g.row_ptr, col_idx=g.col_idx)
        _turns(parent, "--tc-cold-worker", npz, "TC_COLD")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=None,
                    help="rmat scale (17; 19 with --tc-cold or "
                    "--tc-stream-mem)")
    ap.add_argument("--tc-cold", action="store_true",
                    help="cold triangle_count solves, by their parts")
    ap.add_argument("--tc-stream-mem", action="store_true",
                    help="the streamed count's device memory, by stage")
    ap.add_argument("--parent", help="with --tc-cold or --tc-stream-mem: "
                    "root of the parent commit's checkout")
    ap.add_argument("--tc-cold-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tc-stream-mem-worker", nargs=2,
                    metavar=("TREE", "PREFIX"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tc_cold_worker:
        tc_cold_worker(*args.tc_cold_worker)
        return 0
    if args.tc_stream_mem_worker:
        tc_stream_mem_worker(*args.tc_stream_mem_worker)
        return 0
    if args.tc_stream_mem:
        tc_stream_mem(args.parent, args.scale or 19)
        return 0
    if args.tc_cold:
        tc_cold(args.parent, args.scale or 19)
        return 0
    return phases(args.scale or 17)


if __name__ == "__main__":
    raise SystemExit(main())
