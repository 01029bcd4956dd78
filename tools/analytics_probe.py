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

``--decode-kernels`` times K11's ``vgb_tags`` and K12's ``cgr_merge``, at
rmat(19, 16) and at rmat(17, 16):

    python3 tools/analytics_probe.py --decode-kernels [--parent DIR]

The graph (through ``sort_and_clean``) is written once in VarintGB and in
CGR with intervals (``chip_smoke.CGR_STREAMS["interval"]``). Each turn is a
process of its own that builds the kernels of its checkout (the
compiler's register and shared-memory report printed), runs its preps,
and reads, under torch.profiler, the device ms of one ``vgb_tags`` and of
one ``cgr_merge`` as each decode calls it, summed over the pass's kernels
a call, beside the batch ms and the unchanged bounds
(``chip_smoke._vgb_tags_bound``, ``_cgr_merge_bound``); the warm
``varintgb_device_run`` and ``cgr_device_run`` seconds (median of
``DECODE_RUNS``); and the split between long rows and the rest: each
kernel's device ms on the rows above a threshold alone and on the others
alone (VarintGB: a subset of the row lists; CGR: the other rows given no
residuals and no intervals), with the rows' shape (widest rows, rows
above each threshold, the longest interval). The turns run as
``--tc-cold``'s, per scale; the decoded columns of every turn must agree.
One ``DECODE {json}`` line a turn.
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
DECODE_RUNS = 7
VGB_SPLITS = (64, 256, 1024)      # groups a row
CGR_SPLITS = (256, 1024, 4096)    # ids a row


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


def _ptxas(names) -> dict:
    """Each library's -Xptxas -v lines (registers, shared memory, spills)."""
    from graphaibench_tpu_torch.ops import _build

    report = {}
    for name in names:
        _build.load_library(name)
        log = _build.BUILD_DIR.glob(f"gab_{name}_*.log")
        report[name] = [ln.strip() for f in log
                        for ln in f.read_text().splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln]
    return report


def _pass_ms(C, fn, kernel: str) -> dict:
    """Device ms a call of ``fn`` summed over the kernels whose name holds
    ``kernel``, by name, and the batch ms of the same call."""
    by = C._device_ms_by_name(fn, KERNEL_CALLS)
    return {"device_ms": sum(v for k, v in by.items() if kernel in k),
            "by_name": {k: v for k, v in by.items() if kernel in k},
            "batch_ms": C._batch_ms(fn)}


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _vgb_reading(C, DD, K11, vg) -> dict:
    import torch

    prep = DD.varintgb_device_prep(vg, device="cuda")
    chain = (prep["stream"], prep["pos"], prep["ngroups"], prep["gbase"])
    n_g = prep["n_g"]
    tables = prep.get("tag_tables", {})
    out = _pass_ms(C, lambda: K11.vgb_tags(*chain, n_g, **tables),
                   "vgb_tags")
    out["bound_ms"], out["bound_by"], out["bound_bytes"] = (
        C._vgb_tags_bound(prep))
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    out["warm_run_s"] = C._solve_seconds(
        lambda: DD.varintgb_device_run(prep), DECODE_RUNS)
    out["col"] = _digest(DD.varintgb_device_run(prep))
    ng = prep["ngroups"]
    out["widest_groups"] = int(ng.max())
    out["rows"] = int(ng.numel())
    out["n_g"] = n_g
    out["split"] = {}
    for t in VGB_SPLITS:
        part = {}
        for side, keep in (("long", ng > t), ("rest", ng <= t)):
            rows = tuple(a[keep].contiguous() for a in chain[1:])
            part[side] = _pass_ms(C, lambda: K11.vgb_tags(
                chain[0], *rows, n_g), "vgb_tags")["device_ms"]
            part[f"{side}_rows"] = int(keep.sum())
            part[f"{side}_groups"] = int(ng[keep].long().sum())
        out["split"][t] = part
    torch.cuda.synchronize()
    return out


def _merge_rows(prep, keep):
    """cgr_merge's operands on the rows of ``keep`` alone: every other row
    given no residuals and no intervals (degree 0), the kept rows' slots
    of the residual buffer packed after each other."""
    import torch

    res, rp, nres, ip = (prep["res"], prep["row_ptr_d"].long(),
                         prep["nres"], prep["itv_ptr"].long())
    nv = nres.numel()
    deg = rp[1:] - rp[:-1]
    slot_keep = torch.repeat_interleave(keep, deg, output_size=res.numel())
    ni = ip[1:] - ip[:-1]
    itv_keep = torch.repeat_interleave(keep, ni,
                                       output_size=prep["left"].numel())
    length = prep["length"][itv_keep].contiguous()
    i32 = torch.int32

    def ptr(counts):
        p = torch.zeros(nv + 1, dtype=torch.long, device=res.device)
        p[1:] = torch.cumsum(counts, 0)
        return p.to(i32)

    pre = torch.zeros(length.numel() + 1, dtype=torch.long,
                      device=res.device)
    pre[1:] = torch.cumsum(length.long(), 0)
    return (res[slot_keep].contiguous(), ptr(torch.where(keep, deg, 0)),
            torch.where(keep, nres, 0).to(i32), ptr(torch.where(keep, ni, 0)),
            prep["left"][itv_keep].contiguous(), length, pre.to(i32))


def _cgr_reading(C, CD, K12, cg) -> dict:
    import torch

    prep = CD.cgr_device_prep(cg, device="cuda")
    res, _ = K12.cgr_residual(prep["stream"], prep["data_p"], prep["counts"],
                              prep["lane_v_d"], prep["base"], prep["ne"],
                              prep["zeta_k"])
    margs = (res, prep["row_ptr_d"], prep["nres"], prep["itv_ptr"],
             prep["left"], prep["length"], prep["itv_pre"])
    tables = prep.get("merge_tables", {})
    out = _pass_ms(C, lambda: K12.cgr_merge(*margs, **tables), "cgr_merge")
    out["bound_ms"], out["bound_by"], out["bound_bytes"] = (
        C._cgr_merge_bound(prep))
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    out["warm_run_s"] = C._solve_seconds(
        lambda: CD.cgr_device_run(prep), DECODE_RUNS)
    out["col"] = _digest(CD.cgr_device_run(prep)[1])
    rp = prep["row_ptr_d"].long()
    deg = rp[1:] - rp[:-1]
    ni = prep["itv_ptr"].long()[1:] - prep["itv_ptr"].long()[:-1]
    top = torch.argsort(deg, descending=True)[:3]
    out["widest"] = [{"row": int(v), "ids": int(deg[v]),
                      "residuals": int(prep["nres"][v]),
                      "intervals": int(ni[v])} for v in top]
    out["intervals"] = int(prep["left"].numel())
    out["rows_with_intervals"] = int((ni > 0).sum())
    out["longest_interval"] = int(prep["length"].max())
    out["interval_ids"] = int(prep["length"].long().sum())
    prep["res"] = res
    out["split"] = {}
    for t in CGR_SPLITS:
        part = {}
        for side, keep in (("long", deg > t), ("rest", deg <= t)):
            args = _merge_rows(prep, keep)
            part[side] = _pass_ms(C, lambda: K12.cgr_merge(*args),
                                  "cgr_merge")["device_ms"]
            part[f"{side}_rows"] = int(keep.sum())
            part[f"{side}_ids"] = int(deg[keep].sum())
            del args
        out["split"][t] = part
    torch.cuda.synchronize()
    return out


def decode_kernels_worker(tree: str, path: str) -> None:
    """One turn of ``--decode-kernels``: ``vgb_tags`` and ``cgr_merge`` of
    the checkout at ``tree`` on the streams under ``path``."""
    sys.path.insert(0, ROOT)                 # chip_smoke's bounds
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as C
    from graphaibench_tpu_torch.compress import cgr_device as CD
    from graphaibench_tpu_torch.compress import device_decode as DD
    from graphaibench_tpu_torch.compress.cli import load_compressed
    from graphaibench_tpu_torch.ops import cgr_decode as K12
    from graphaibench_tpu_torch.ops import vbyte_decode as K11

    import graphaibench_tpu_torch
    assert graphaibench_tpu_torch.__file__.startswith(os.path.abspath(tree))
    res = {"tree": tree, "ptxas": _ptxas(("vbyte_decode", "cgr_decode"))}
    vg = load_compressed(os.path.join(path, "vgb"))
    res["nv"], res["ne"] = vg.nv, vg.ne
    res["vgb_tags"] = _vgb_reading(C, DD, K11, vg)
    del vg
    res["cgr_merge"] = _cgr_reading(C, CD, K12,
                                    load_compressed(os.path.join(path, "cgr")))
    res["vgb_col"] = res["vgb_tags"].pop("col")
    res["cgr_col"] = res["cgr_merge"].pop("col")
    print("DECODE " + json.dumps(res))


def decode_kernels(parent: str | None, scales) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat
    from graphaibench_tpu_torch.compress import cgr, vbyte
    from graphaibench_tpu_torch.compress.cli import save_compressed
    from graphaibench_tpu_torch.graph.transforms import sort_and_clean

    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        for scale in scales:
            t0 = time.perf_counter()
            d = os.path.join(tmp, f"rmat{scale}")
            g = sort_and_clean(rmat(scale, 16, seed=0, cache=False))
            save_compressed(vbyte.encode_graph(g, "varintgb"),
                            os.path.join(d, "vgb"))
            save_compressed(cgr.encode_graph(g, C.CGR_STREAMS["interval"]),
                            os.path.join(d, "cgr"))
            del g
            print(f"rmat({scale}, 16) encoded in "
                  f"{time.perf_counter() - t0:.1f} s")
            _turns(parent, "--decode-kernels-worker", d, "DECODE",
                   agree=("vgb_col", "cgr_col"))


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
    ap.add_argument("--decode-kernels", action="store_true",
                    help="K11's vgb_tags and K12's cgr_merge a decode, at "
                    "rmat19 and rmat17 (or --scale)")
    ap.add_argument("--parent", help="with --tc-cold, --tc-stream-mem, "
                    "--kernels or --decode-kernels: "
                    "root of the parent commit's checkout")
    ap.add_argument("--tc-cold-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--kernels-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--decode-kernels-worker", nargs=2,
                    metavar=("TREE", "DIR"), help=argparse.SUPPRESS)
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
    if args.decode_kernels_worker:
        decode_kernels_worker(*args.decode_kernels_worker)
        return 0
    if args.decode_kernels:
        decode_kernels(args.parent, [args.scale] if args.scale else [19, 17])
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
