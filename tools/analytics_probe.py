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

``--kernels`` times K9 and K10 alone, at rmat(19, 16) and at rmat(17, 16):

    python3 tools/analytics_probe.py --kernels [--parent DIR]

Each turn is a process of its own that builds K9 and K10 of its checkout
(the compiler's register and shared-memory report printed), then reads,
under torch.profiler, the device ms of one ``tc_count`` and of one
``hindex_sweep`` at three states of the fixpoint (from the degrees, after
sweep 1, and the last sweep's input), each kernel of a sweep by its name,
and the summed device ms of every K10 kernel over one whole
``k_core_hindex`` solve (median of ``KERNEL_SOLVES``), beside the batch ms
of the same calls and the unchanged bounds (``chip_smoke._tc_bound``,
``_hindex_bound``). The turns run as ``--tc-cold``'s, per scale, on graphs
written once; the triangles, the coreness and the sweeps of every turn must
agree. One ``KERNELS {json}`` line a turn.
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
KERNEL_SOLVES = 3
KERNEL_CALLS = 20


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


def kernels_worker(tree: str, graph_npz: str) -> None:
    """One turn of ``--kernels``: K9 and K10 of the checkout at ``tree`` on
    the graph in ``graph_npz``."""
    sys.path.insert(0, ROOT)                 # chip_smoke's bounds
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as C
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.analytics import kcore as KC
    from graphaibench_tpu_torch.analytics import tc as TC
    from graphaibench_tpu_torch.ops import _build
    from graphaibench_tpu_torch.ops import hindex as K10
    from graphaibench_tpu_torch.ops import tc_count as K9

    import graphaibench_tpu_torch
    assert graphaibench_tpu_torch.__file__.startswith(os.path.abspath(tree))
    report = {}
    for name in ("tc_count", "kcore_hindex"):
        _build.load_library(name)
        log = _build.BUILD_DIR.glob(f"gab_{name}_*.log")
        report[name] = [ln.strip() for f in log
                        for ln in f.read_text().splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln]
    z = np.load(graph_npz)
    g = CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"])
    res = {"tree": tree, "nv": g.nv, "ne": g.ne, "ptxas": report}

    t0 = time.perf_counter()
    dag = TC._tc_device_state(g, "cuda")
    torch.cuda.synchronize()
    res["tc_state_s"] = time.perf_counter() - t0
    res["triangles"] = int(K9.tc_count(dag))
    bound_ms, bound_by, _ = C._tc_bound(dag)
    by = C._device_ms_by_name(lambda: K9.tc_count(dag), KERNEL_CALLS)
    res["tc_count"] = {
        "device_ms": sum(v for k, v in by.items() if "tc_" in k),
        "by_name": by, "batch_ms": C._batch_ms(lambda: K9.tc_count(dag)),
        "bound_ms": bound_ms, "bound_by": bound_by}

    layout = KC.hindex_state(g, device="cuda")
    deg = torch.from_numpy(g.degrees().astype(np.int32)).cuda()
    states, core = [deg], deg
    while True:
        new, changed = K10.hindex_sweep(layout, core)
        if int(changed) == 0:
            break
        core = new
        if len(states) == 1:
            states.append(core)
    tagged = {"from_degrees": states[0], "after_sweep_1": states[-1],
              "last_sweep": core}
    res["hindex_sweep"] = {}
    for tag, st in tagged.items():
        by = C._device_ms_by_name(lambda: K10.hindex_sweep(layout, st),
                                KERNEL_CALLS)
        bound_ms, bound_by, _ = C._hindex_bound(layout, st)
        res["hindex_sweep"][tag] = {
            "device_ms": sum(v for k, v in by.items() if "hindex" in k),
            "by_name": by,
            "batch_ms": C._batch_ms(lambda: K10.hindex_sweep(layout, st)),
            "bound_ms": bound_ms, "bound_by": bound_by}
    solves = []
    for _ in range(KERNEL_SOLVES):
        counted = KC._hindex_sweep
        n = [0]

        def sweep(c, lay):
            n[0] += 1
            return counted(c, lay)

        KC._hindex_sweep = sweep
        try:
            by = C._device_ms_by_name(
                lambda: KC.k_core_hindex(g, layout=layout), 1)
            torch.cuda.synchronize()
            n[0] = 0
            t0 = time.perf_counter()
            final = KC.k_core_hindex(g, layout=layout)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        finally:
            KC._hindex_sweep = counted
        sweeps = n[0]
        solves.append({"device_ms": sum(v for k, v in by.items()
                                        if "hindex" in k),
                       "by_name": by, "host_s": host_s})
    solves.sort(key=lambda s: s["device_ms"])
    res["solve"] = dict(solves[len(solves) // 2], sweeps=sweeps,
                        all_device_ms=[s["device_ms"] for s in solves])
    res["sweeps"] = res["solve"]["sweeps"]
    res["core_sum"] = int(final.long().sum())
    res["core_max"] = int(final.max())
    deg_np = g.degrees()
    res["hubs"] = int((deg_np > 1024).sum())
    res["widest"] = int(deg_np.max())
    print("KERNELS " + json.dumps(res))


def kernels(parent: str | None, scales) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat

    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        for scale in scales:
            npz = os.path.join(tmp, f"rmat{scale}.npz")
            g = rmat(scale, 16, seed=0, cache=False)
            np.savez(npz, row_ptr=g.row_ptr, col_idx=g.col_idx)
            del g
            _turns(parent, "--kernels-worker", npz, "KERNELS",
                   agree=("triangles", "core_sum", "core_max", "sweeps"))


def _turns(parent: str | None, worker: str, path: str, tag: str,
           agree=()) -> None:
    """Run ``worker`` on ``path`` with the change alone, or with parent,
    change, change, parent; print each turn's ``tag`` line. The keys in
    ``agree`` must be equal in every turn."""
    first = None
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
        first = first or res
        for key in agree:
            if res[key] != first[key]:
                raise SystemExit(f"the {name} turn's {key} {res[key]} "
                                 f"differs from {first[key]}")


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
    ap.add_argument("--kernels", action="store_true",
                    help="K9 a count and K10's sweeps and solve, at rmat19 "
                    "and rmat17 (or --scale)")
    ap.add_argument("--parent", help="with --tc-cold, --tc-stream-mem or "
                    "--kernels: "
                    "root of the parent commit's checkout")
    ap.add_argument("--tc-cold-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--kernels-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--tc-stream-mem-worker", nargs=2,
                    metavar=("TREE", "PREFIX"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tc_cold_worker:
        tc_cold_worker(*args.tc_cold_worker)
        return 0
    if args.kernels_worker:
        kernels_worker(*args.kernels_worker)
        return 0
    if args.kernels:
        kernels(args.parent, [args.scale] if args.scale else [19, 17])
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
