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
One ``DECODE {json}`` line a turn. ``--decoders`` picks some of the four
readings (``vgb,cgr,svb,res``, the default all): ``svb`` times K11's
``svb_decode`` on rmat(scale, 16) in StreamVByte (every row) and in hybrid
at threshold 32 (its high rows), each a decode, beside the unchanged
``chip_smoke._svb_decode_bound``, with the warm ``streamvbyte_device_run``
and ``hybrid_device_run``, and split into the rows above each of
``SVB_SPLITS`` values alone and the others alone:

    python3 tools/analytics_probe.py --decode-kernels --decoders svb [--parent DIR]

The VarintGB reading also times ``vgb_values`` (its tag positions from
``vgb_tags``) a decode beside ``chip_smoke._vgb_values_bound``, and on the
rows of each class of ``VALUE_CLASSES`` (groups a row) alone. ``res`` times
K12's ``cgr_residual`` on rmat(scale, 16) in plain CGR
(``chip_smoke.CGR_STREAMS["plain"]``, every lane, with the warm
``cgr_device_run``) and on hybrid's low rows at threshold 32 (a lane a row,
with the warm ``hybrid_device_run``), each beside
``chip_smoke._cgr_residual_bound`` and the warps' wait for their longest
lane (32 times the sum of each warp's largest count over the codes, the
lane table as it is), on the lanes sorted by count within windows of 256
lanes (a checkout whose kernel takes a thread a lane) or with its tiles
taking their lanes in lane order, not by count (a checkout whose kernel
takes tiles), and on the lanes of each class of ``CODE_CLASSES`` (codes a
lane) alone:

    python3 tools/analytics_probe.py --decode-kernels --decoders vgb,res --scale 19 [--parent DIR]

``--variants`` works here as for ``--pull-kernels`` below, over
``csrc/vbyte_decode.cu`` and ``csrc/cgr_decode.cu``; a choice named like a
constant of ``ops/vbyte_decode.py`` or ``ops/cgr_decode.py``
(``SVB_TILE_QUADS=112``) sets it before the preps build their tables.

``--first-fit`` times K14 ``first_fit`` and K12 ``cgr_gamma``, at
rmat(19, 16) seed 0 (``chip_smoke``'s analytics graph; or ``--scale``):

    python3 tools/analytics_probe.py --first-fit [--parent DIR]

The graph is written once, and through ``sort_and_clean`` in CGR three
times: the default config, the same with a degree in each header, and with
intervals in 64-bit interval segments. Each turn is a process of its own
that builds K14 and K12 of its checkout (the compiler's register report
printed) and reads: K14 on the three states of
``chip_smoke._first_fit_states`` (round 1, random colours on 60% of the
rows, random colours below 3), each its device ms (the mean of
``KERNEL_CALLS`` launches under torch.profiler, every kernel the call
launches by name), batch ms and bound (the ids of the active rows read
once); one warm ``color`` solve round by round (``coloring.py``'s loop
repeated by ``chip_smoke._color_rounds``, ``int(active.sum())`` read each
round): the active rows and K14's device ms of every round, the solve's
device ms by kernel name, and the warm seconds of ``color`` itself (median
of ``SOLVES_WARM``); and ``cgr_gamma`` on its four launch kinds (HEADER on
the default stream's vertices, HEADER_DEG on the degree stream's, COUNT on
every residual segment of the default stream, and the interval stream's
residual headers at ``res_pos``, 0 for a vertex with no interval section,
as the prep finds them and in a random order), each against its plain
version, its device ms, batch ms and bound, with how far its positions are
sorted. The turns run as ``--tc-cold``'s; the colours, the rounds and
every ``cgr_gamma`` output must agree. One ``FIRST_FIT {json}`` line a
turn. ``--variants`` works as for ``--pull-kernels``, over
``csrc/coloring.cu`` and ``csrc/cgr_decode.cu``; a choice named like a
constant of ``ops/first_fit.py`` (``HUB_SLICE=1048576``) sets it before the
tables are built.

``--pull-kernels`` times K8 ``neighbor_reduce`` at rmat(19, 16) (or
``--scale``):

    python3 tools/analytics_probe.py --pull-kernels [--parent DIR]

Each turn is a process of its own that builds K8 of its checkout (the
compiler's register report printed), then reads under torch.profiler: the
summed K8 device ms and the launches of one whole solve of each pull solver
(BFS from 0, Bellman-Ford with symmetric and with asymmetric weights,
PageRank, CC, ``k_core_peel``, ``bc_single_source`` from 0); one sweep of
each case (int32 min and sum, float32 sum, float32 min with packed edge
values) beside the batch ms and the unchanged ``chip_smoke._pull_bound``;
the same sweeps on the graph's rows split by class, each class alone (the
narrow buckets of width 4-8, the wider buckets of width 16-64, the split
rows of degree above 64, every virtual row of theirs), and on the whole
graph with every neighbour id set to 0 (the id stream with every gather
hitting one line). Two probe kernels compiled from this file give the
floors: the id arrays streamed alone (int4 loads, an xor a row) and as
many gathers of ``vals`` at uniformly random ids with no id stream, over
all of ``vals``, over its first 32,768 values (L1 holds them) and over one
line. The
turns run as ``--tc-cold``'s; the solves' results must agree. One
``PULL {json}`` line a turn. ``--variants "A;B"`` adds a turn of the
change under each variant, between two of the change as it is and between
the parent's. A variant sets integer constants of ``csrc/ell_pull.cu``
(``constexpr int NAME = ...;``, choices split by ``,``) in a copy of
``csrc/`` under ``build/probe_variants/``, from which K8 alone is rebuilt:

    python3 tools/analytics_probe.py --pull-kernels --parent DIR \
        --variants "kPullQuads=1;kPullQuads=4,kPullMaxLg=4"

``--parent`` takes several checkouts split by ``,`` (the parent commit's
and, say, an earlier state of the change): their turns come first in that
order and last in the reverse one.
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
SOLVES_WARM = 5
DECODE_RUNS = 7
VGB_SPLITS = (64, 256, 1024)      # groups a row
# vgb_values' row classes by groups a row, and cgr_residual's lane classes
# by codes a lane: (name, least, most)
VALUE_CLASSES = (("1", 1, 1), ("2-8", 2, 8), ("9-256", 9, 256),
                 ("257+", 257, 2**31 - 1))
CODE_CLASSES = (("0-8", 0, 8), ("9-16", 9, 16), ("17-32", 17, 32),
                ("33+", 33, 2**31 - 1))
WARP = 32
CGR_SPLITS = (256, 1024, 4096)    # ids a row
SVB_SPLITS = (256, 1024)          # values a row
HYBRID_THRESHOLD = 32             # hybrid's default degree threshold
# the solves whose results are exact (PageRank and BC add floats in an
# order that changes from run to run)
EXACT_SOLVES = ("bfs", "sssp symmetric", "sssp asymmetric", "cc",
                "k_core_peel")
GATHER_SPANS = (32768, 32)   # 128 KiB of vals (L1 holds it); one line
PULL_CASES = {                    # case -> (vals dtype, kind, edge values)
    "int32 min": ("int32", "min", False),
    "int32 sum": ("int32", "sum", False),
    "float32 sum": ("float32", "sum", False),
    "float32 min packed": ("float32", "min", True),
}
# the floors of a pull sweep: the id arrays streamed alone, and random
# gathers of vals with no id stream (ids from a hash of the slot, below a
# span: all of vals, GATHER_SPANS' first entries of it)
PULL_FLOOR_SRC = r"""
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
__global__ void ids_only(const int4* __restrict__ ids, long long n4,
                         int per_row4, int* __restrict__ out) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r * per_row4 >= n4) return;
  int x = 0;
  for (int k = 0; k < per_row4; ++k) {
    const int4 q = __ldcs(ids + r * per_row4 + k);
    x ^= q.x ^ q.y ^ q.z ^ q.w;
  }
  if (x == 0x7fffffff) out[0] = x;   // keeps the loads
}
__global__ void gather_only(const int* __restrict__ vals, unsigned span,
                            long long n, int* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (8 * t >= n) return;
  int m = INT_MAX;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned h = static_cast<unsigned>(8 * t + k) * 2654435761u;
    h ^= h >> 15; h *= 2246822519u; h ^= h >> 13;
    m = min(m, __ldg(vals + h % span));
  }
  if (m == INT_MIN + 1) out[0] = m;   // keeps the loads
}
extern "C" int probe_ids_only(const void* ids, long long n4, int per_row4,
                              void* out, void* stream) {
  const long long rows = (n4 + per_row4 - 1) / per_row4;
  ids_only<<<(unsigned)((rows + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int4*)ids, n4, per_row4, (int*)out);
  return (int)cudaGetLastError();
}
extern "C" int probe_gather_only(const void* vals, unsigned span,
                                 long long n, void* out, void* stream) {
  const long long threads = (n + 7) / 8;
  gather_only<<<(unsigned)((threads + 255) / 256), 256, 0,
                 (cudaStream_t)stream>>>((const int*)vals, span, n, (int*)out);
  return (int)cudaGetLastError();
}
"""


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


def _use_variant(defines: str, sources) -> list:
    """Build ``sources`` (of ``csrc/``) from a copy of ``csrc/`` under
    ``build/probe_variants/`` whose ``constexpr int NAME = ...;`` lines
    take the comma-separated ``NAME=VALUE`` choices in ``defines``; every
    choice must name one such constant of the sources. Returns the
    choices that name none, for the caller to apply."""
    import re
    import shutil

    from graphaibench_tpu_torch.ops import _build

    choices = [d.partition("=") for d in defines.split(",") if d]
    texts = {src: (_build.CSRC / src).read_text() for src in sources}
    rest, patched = [], False
    for name, _, value in choices:
        pat = re.compile(rf"constexpr int {re.escape(name)} = [^;]+;")
        hits = [src for src, text in texts.items() if pat.search(text)]
        if not hits:
            rest.append((name, value))
            continue
        if len(hits) > 1 or len(pat.findall(texts[hits[0]])) != 1:
            raise SystemExit(f"variant {name}: not one constant of {sources}")
        texts[hits[0]] = pat.sub(f"constexpr int {name} = {int(value)};",
                                 texts[hits[0]])
        patched = True
    if patched:
        tag = re.sub(r"[^\w=,-]", "_", defines)
        csrc = _build.BUILD_DIR.parent / "probe_variants" / tag / "csrc"
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(_build.CSRC, csrc)
        for src, text in texts.items():
            (csrc / src).write_text(text)
        _build.CSRC = csrc
        _build.SOURCES = tuple(sources)
    return rest


def _pull_floor_lib():
    """The probe kernels of PULL_FLOOR_SRC, compiled by nvcc into the build
    directory."""
    import ctypes

    from graphaibench_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "pull_floor.cu"
    so = _build.BUILD_DIR / f"pull_floor_{os.getpid()}.so"
    src.write_text(PULL_FLOOR_SRC)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.probe_ids_only.argtypes = [vp, i64, ctypes.c_int, vp, vp]
    lib.probe_gather_only.argtypes = [vp, ctypes.c_uint, i64, vp, vp]
    return lib


def _pull_rows(dg, keep):
    """``dg`` with only the virtual rows that ``keep(bucket)`` (a bool mask
    a bucket) selects, buckets left empty dropped."""
    import dataclasses

    import torch

    from graphaibench_tpu_torch.ops.device_graph import EllBucket

    ell = []
    for b in dg.ell:
        idx = torch.nonzero(keep(b)).flatten()
        if not idx.numel():
            continue
        slots = (idx[:, None] * b.width + torch.arange(
            b.width, device=idx.device)[None, :]).flatten()
        ell.append(EllBucket(
            row_ids=b.row_ids[idx].contiguous(),
            nbr=b.nbr[slots].contiguous(),
            edge_id=b.edge_id[slots].contiguous(), width=b.width,
            valid=b.valid[idx].contiguous()))
    return dataclasses.replace(dg, ell=tuple(ell))


def pull_kernels_worker(tree: str, graph_npz: str, defines: str = "") -> None:
    """One turn of ``--pull-kernels``: K8 of the checkout at ``tree`` on
    the graph in ``graph_npz``, built with the constants ``defines``
    (``_use_variant``)."""
    import ctypes
    import dataclasses

    sys.path.insert(0, ROOT)                 # chip_smoke's bounds
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as C
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.analytics import bc as BCM
    from graphaibench_tpu_torch.analytics import cc as CCM
    from graphaibench_tpu_torch.analytics import kcore as KCM
    from graphaibench_tpu_torch.analytics import pr as PRM
    from graphaibench_tpu_torch.analytics import traversal as TR
    from graphaibench_tpu_torch.ops import _build
    from graphaibench_tpu_torch.ops import ell_pull as K8
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    import graphaibench_tpu_torch
    assert graphaibench_tpu_torch.__file__.startswith(os.path.abspath(tree))
    unknown = _use_variant(defines, ("ell_pull.cu",))
    if unknown:
        raise SystemExit(f"no constants {unknown} in csrc/ell_pull.cu")
    res = {"tree": tree, "defines": defines, "ptxas": _ptxas(("ell_pull",))}
    z = np.load(graph_npz)
    g = CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"])
    dg = to_device_graph(g, device="cuda")
    res["nv"], res["ne"] = g.nv, g.ne
    res["buckets"] = [(b.width, b.rows) for b in dg.ell]
    rng = np.random.default_rng(1)
    rev = dg.trans_perm.cpu().numpy()
    w = {"symmetric": rng.uniform(0.1, 2.0, g.ne).astype(np.float32)[
             np.minimum(np.arange(g.ne), rev)],
         "asymmetric": rng.uniform(0.1, 2.0, g.ne).astype(np.float32)}
    w = {k: torch.from_numpy(v).cuda() for k, v in w.items()}
    solves = {
        "bfs": lambda: TR.bfs(dg, 0),
        "sssp symmetric": lambda: TR.sssp_bellman_ford(dg, w["symmetric"], 0),
        "sssp asymmetric": lambda: TR.sssp_bellman_ford(dg, w["asymmetric"],
                                                        0),
        "pagerank": lambda: PRM.pagerank(dg)[0],
        "cc": lambda: CCM.connected_components(dg),
        "k_core_peel": lambda: KCM.k_core_peel(dg),
        "bc": lambda: BCM.bc_single_source(dg, 0),
    }
    res["solves"], res["digests"] = {}, {}
    for name, fn in solves.items():
        before = K8.LAUNCHES["neighbor_reduce"]
        out = fn()
        torch.cuda.synchronize()
        launches = K8.LAUNCHES["neighbor_reduce"] - before
        if name in EXACT_SOLVES:
            res["digests"][name] = _digest(out)
        by = C._device_ms_by_name(fn, 1)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        res["solves"][name] = {
            "launches": launches, "host_s": time.perf_counter() - t0,
            "k8_device_ms": sum(v for k, v in by.items()
                                if "neighbor_reduce" in k),
            "all_device_ms": sum(by.values())}
    gen = torch.Generator(device="cuda").manual_seed(4)
    vals = {"int32": torch.randint(0, 2, (g.nv,), dtype=torch.int32,
                                   device="cuda", generator=gen),
            "float32": torch.randn(g.nv, device="cuda", generator=gen)}
    ev = torch.rand(g.ne, device="cuda", generator=gen) + 0.25

    def sweeps(graph) -> dict:
        out = {}
        packed = K8.pack_neighbor_edge_vals(graph, ev)
        for case, (dtype, kind, edge) in PULL_CASES.items():
            e = packed if edge else None
            fn = lambda: K8.neighbor_reduce(graph, vals[dtype], kind, e)  # noqa: E731
            out[case] = C._kernel_device_ms(fn, "neighbor_reduce")
        return out

    res["sweep"] = {}
    for case, (dtype, kind, edge) in PULL_CASES.items():
        e = K8.pack_neighbor_edge_vals(dg, ev) if edge else None
        fn = lambda: K8.neighbor_reduce(dg, vals[dtype], kind, e)  # noqa: E731
        bound_ms, bound_by, nbytes = C._pull_bound(dg, edge)
        batch_ms = C._batch_ms(fn)
        device_ms = C._kernel_device_ms(fn, "neighbor_reduce",
                                        at_least_ms=batch_ms / 2)
        res["sweep"][case] = {
            "device_ms": device_ms, "batch_ms": batch_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "share_of_bound": bound_ms / device_ms if device_ms else None}
        if case != "float32 sum":     # adds in an order that varies
            res["digests"][f"sweep {case}"] = _digest(fn())
    split = dg.is_split.bool()
    classes = {
        "narrow 4-8": lambda b: (~split[b.row_ids.long()]) & (b.width <= 8),
        "wide 16-64": lambda b: (~split[b.row_ids.long()]) & (b.width >= 16),
        "split rows": lambda b: split[b.row_ids.long()],
    }
    res["classes"] = {}
    for name, keep in classes.items():
        sub = _pull_rows(dg, keep)
        res["classes"][name] = {
            "virtual_rows": sum(b.rows for b in sub.ell),
            "slots": sum(b.rows * b.width for b in sub.ell),
            "real_slots": int(sum(b.valid.long().sum() for b in sub.ell)),
            "device_ms": sweeps(sub)}
        del sub
    zero = dataclasses.replace(dg, ell=tuple(
        dataclasses.replace(b, nbr=torch.zeros_like(b.nbr)) for b in dg.ell))
    res["classes"]["ids, every gather at vertex 0"] = {"device_ms": sweeps(zero)}
    del zero
    lib = _pull_floor_lib()
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ids = {b.width: b.nbr for b in dg.ell}
    slots = sum(b.nbr.numel() for b in dg.ell)
    real = int(sum(b.valid.long().sum() for b in dg.ell))

    def ids_pass():
        for width, nbr in ids.items():
            lib.probe_ids_only(nbr.data_ptr(), nbr.numel() // 4, width // 4,
                               sink.data_ptr(), stream)

    by = C._device_ms_by_name(ids_pass, KERNEL_CALLS)
    res["floors"] = {
        "ids_only_device_ms": sum(v for k, v in by.items() if "ids_only" in k),
        "id_bytes": 4 * slots,
        "gather_only_device_ms": C._kernel_device_ms(
            lambda: lib.probe_gather_only(vals["int32"].data_ptr(), g.nv, real,
                                          sink.data_ptr(), stream),
            "gather_only"),
        "gathers": real}
    for span in GATHER_SPANS:
        res["floors"][f"gather_only_span_{span}_device_ms"] = (
            C._kernel_device_ms(lambda: lib.probe_gather_only(
                vals["int32"].data_ptr(), span, real, sink.data_ptr(),
                stream), "gather_only"))
    print("PULL " + json.dumps(res))


def _ptxas(names) -> dict:
    """Each library's -Xptxas -v lines (registers, shared memory, spills)."""
    from graphaibench_tpu_torch.ops import _build

    report = {}
    for name in names:
        _build.load_library(name)
        log = _build._library_path(f"{name}.cu").with_suffix(".log")
        report[name] = [ln.strip() for ln in log.read_text().splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling" in ln]
    return report


def _pass_ms(C, fn, kernel: str, whole: bool = True) -> dict:
    """Device ms a call of ``fn`` summed over the kernels whose name holds
    ``kernel``, by name, and the batch ms of the same call. For a
    ``whole`` decode's pass, which holds most of its call, a trace whose
    device work a call reads below half the batch ms is the profiler's and
    is taken again; a part of the rows may be shorter than the call's host
    work."""
    batch_ms = C._batch_ms(fn)
    by = C._device_ms_by_name(fn, KERNEL_CALLS,
                              at_least_ms=batch_ms / 2 if whole else None)
    return {"device_ms": sum(v for k, v in by.items() if kernel in k),
            "by_name": {k: v for k, v in by.items() if kernel in k},
            "batch_ms": batch_ms}


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _vgb_values_reading(C, K11, prep) -> dict:
    """vgb_values as the VarintGB decode calls it, beside its bound, and on
    the rows of each of VALUE_CLASSES alone (under the tables built for
    them, where the checkout's wrapper takes tables)."""
    import torch

    stream, n_g = prep["stream"], prep["n_g"]
    tagpos = K11.vgb_tags(stream, prep["pos"], prep["ngroups"], prep["gbase"],
                          n_g, **prep.get("tag_tables", {}))
    rows = (prep["gbase"], prep["counts"], prep["out_slot"])
    col = torch.empty(prep["ne"], dtype=torch.int32, device="cuda")
    tables = prep.get("value_tables", {})
    out = _pass_ms(C, lambda: K11.vgb_values(stream, tagpos, *rows, col,
                                             **tables), "vgb_values")
    out["bound_ms"], out["bound_by"], out["bound_bytes"] = (
        C._vgb_values_bound(prep))
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    ng = prep["ngroups"].long()
    out["classes"] = {}
    for name, lo, hi in VALUE_CLASSES:
        keep = (ng >= lo) & (ng <= hi)
        sub = tuple(a[keep].contiguous() for a in rows)
        sub_tables = (K11.vgb_value_tables(*sub)
                      if hasattr(K11, "vgb_value_tables") else {})
        out["classes"][name] = {
            "device_ms": _pass_ms(C, lambda: K11.vgb_values(
                stream, tagpos, *sub, col, **sub_tables), "vgb_values",
                whole=False)["device_ms"],
            "rows": int(keep.sum()), "groups": int(ng[keep].sum())}
    torch.cuda.synchronize()
    return out


def _warp_max_factor(counts) -> float:
    """32 times the sum over warps of a warp's largest count, over the sum
    of the counts: how many lanes' codes the warps of a thread-a-lane pass
    take for each code decoded."""
    import torch

    c = counts.long().clamp(min=0)
    pad = (-c.numel()) % WARP
    warps = torch.cat([c, c.new_zeros(pad)]).view(-1, WARP)
    return float(WARP * warps.max(1).values.sum()) / max(float(c.sum()), 1.0)


def _sorted_in_windows(lanes, width: int = 256):
    """The lane tables with each window of ``width`` consecutive lanes
    ordered by count, largest first: the same output, warps of like
    counts."""
    import torch

    c = lanes[1].long().clamp(min=0)
    win = torch.arange(c.numel(), device=c.device) // width
    order = torch.argsort(win * 2**32 - c, stable=True)
    return tuple(a[order].contiguous() for a in lanes)


def _residual_reading(C, K12, stream, lanes, ne: int, zeta_k: int,
                      tables: dict) -> dict:
    """cgr_residual on ``lanes`` (data_p, counts, lane_v, base) beside its
    bound and the warps' wait for their longest lane (the lane table as it
    is); on the lanes sorted by count within windows of 256 (a thread a
    lane) or with each tile's lanes in lane order (tiles); and on the
    lanes of each of CODE_CLASSES alone."""
    import torch

    def fn(ls=lanes, t=tables):
        return K12.cgr_residual(stream, *ls, ne, zeta_k, **t)

    out = _pass_ms(C, fn, "cgr_residual")
    _, pfin = fn()
    bits = float((pfin.long() - lanes[0].long()).sum())
    counts = lanes[1].long()
    ids = int(counts.clamp(min=0).sum())
    out["bound_ms"], out["bound_by"], out["bound_bytes"] = (
        C._cgr_residual_bound(lanes[0].numel(), ids, bits))
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    out["lanes"], out["ids"] = int(counts.numel()), ids
    out["warp_max_factor"] = _warp_max_factor(counts)
    q = torch.quantile(counts.double(), torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64, device=counts.device))
    out["codes_p50_p90_p99_max"] = [*map(float, q), int(counts.max())]
    if not hasattr(K12, "residual_tables"):
        # a thread a lane: the lanes sorted by count within 256
        srt = _sorted_in_windows(lanes)
        out["sorted_in_256"] = {
            "device_ms": _pass_ms(C, lambda: fn(srt, {}), "cgr_residual",
                                  whole=False)["device_ms"],
            "warp_max_factor": _warp_max_factor(srt[1])}
    else:
        # the tables' tiles with each tile's lanes taken in lane order
        t = tables or K12.residual_tables(lanes[1])
        ident = dict(t, order=torch.arange(counts.numel(), dtype=torch.int32,
                                           device=counts.device))
        out["lane_order"] = _pass_ms(C, lambda: fn(lanes, ident),
                                     "cgr_residual", whole=False)["device_ms"]
    out["classes"] = {}
    for name, lo, hi in CODE_CLASSES:
        keep = (counts >= lo) & (counts <= hi)
        sub = tuple(a[keep].contiguous() for a in lanes)
        sub_tables = (K12.residual_tables(sub[1])
                      if hasattr(K12, "residual_tables") else {})
        out["classes"][name] = {
            "device_ms": _pass_ms(C, lambda: fn(sub, sub_tables),
                                  "cgr_residual", whole=False)["device_ms"],
            "lanes": int(keep.sum()), "ids": int(counts[keep].sum()),
            "warp_max_factor": _warp_max_factor(sub[1])}
    torch.cuda.synchronize()
    return out


def _cgr_plain_reading(C, CD, K12, cg) -> dict:
    """cgr_residual on the plain CGR stream's lanes, as its decode calls
    it, with the warm cgr_device_run."""
    prep = CD.cgr_device_prep(cg, device="cuda")
    lanes = (prep["data_p"], prep["counts"], prep["lane_v_d"], prep["base"])
    out = _residual_reading(C, K12, prep["stream"], lanes, prep["ne"],
                            prep["zeta_k"], prep.get("res_tables", {}))
    out["warm_run_s"] = C._solve_seconds(lambda: CD.cgr_device_run(prep),
                                         DECODE_RUNS)
    out["col"] = _digest(CD.cgr_device_run(prep)[1])
    return out


def _hybrid_low_reading(C, DD, K12, hg) -> dict:
    """cgr_residual on hybrid's low rows (a lane a row), as its decode
    calls it, with the warm hybrid_device_run."""
    prep = DD.hybrid_device_prep(hg, device="cuda")
    out = _residual_reading(C, K12, prep["stream"], prep["low"], prep["ne"],
                            prep["zeta_k"], prep.get("res_tables", {}))
    out["warm_run_s"] = C._solve_seconds(lambda: DD.hybrid_device_run(prep),
                                         DECODE_RUNS)
    out["col"] = _digest(DD.hybrid_device_run(prep))
    return out


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
                chain[0], *rows, n_g), "vgb_tags", whole=False)["device_ms"]
            part[f"{side}_rows"] = int(keep.sum())
            part[f"{side}_groups"] = int(ng[keep].long().sum())
        out["split"][t] = part
    torch.cuda.synchronize()
    out["values"] = _vgb_values_reading(C, K11, prep)
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
                                  "cgr_merge", whole=False)["device_ms"]
            part[f"{side}_rows"] = int(keep.sum())
            part[f"{side}_ids"] = int(deg[keep].sum())
            del args
        out["split"][t] = part
    torch.cuda.synchronize()
    return out


def _svb_reading(C, DD, K11, obj, hybrid: bool) -> dict:
    """svb_decode as the StreamVByte (or, with ``hybrid``, the hybrid)
    decode calls it: a decode's device ms and batch ms beside the bound, the
    warm run, and the split by row length."""
    import torch

    if hybrid:
        prep = DD.hybrid_device_prep(obj, device="cuda")
        rows = prep["high"]
        run = DD.hybrid_device_run
    else:
        prep = DD.streamvbyte_device_prep(obj, device="cuda")
        deg = prep["degrees"]
        rows = (prep["word_offsets"][:prep["nv"]] * 4 + 4, deg,
                torch.cumsum(deg, 0, dtype=torch.int32) - deg)
        run = DD.streamvbyte_device_run
    stream, ne = prep["stream"], prep["ne"]
    tables = prep.get("svb_tables", {})
    col = torch.empty(ne, dtype=torch.int32, device="cuda")
    fn = lambda: K11.svb_decode(stream, *rows, col, **tables)  # noqa: E731
    out = _pass_ms(C, fn, "svb_decode")
    n = rows[1].long()
    # the bytes of the rows decoded (hybrid: its high rows' chunks alone)
    nbytes = (int(np.diff(obj.offsets)[np.asarray(obj.degrees)
                                        >= obj.threshold].sum())
              if hybrid else stream.numel())
    out["bound_ms"], out["bound_by"], out["bound_bytes"] = (
        C._svb_decode_bound(nbytes, n.numel(), int(n.sum())))
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    out["warm_run_s"] = C._solve_seconds(lambda: run(prep), DECODE_RUNS)
    out["col"] = _digest(run(prep))
    out["rows"] = int(n.numel())
    out["values"] = int(n.sum())
    out["widest"] = int(n.max())
    out["split"] = {}
    for t in SVB_SPLITS:
        part = {}
        for side, keep in (("long", n > t), ("rest", n <= t)):
            sub = tuple(a[keep].contiguous() for a in rows)
            sub_tables = (K11.svb_tables(sub[1])
                          if hasattr(K11, "svb_tables") else {})
            part[side] = _pass_ms(C, lambda: K11.svb_decode(
                stream, *sub, col, **sub_tables), "svb_decode",
                whole=False)["device_ms"]
            part[f"{side}_rows"] = int(keep.sum())
            part[f"{side}_values"] = int(n[keep].sum())
        out["split"][t] = part
    torch.cuda.synchronize()
    return out


def decode_kernels_worker(tree: str, path: str, decoders: str,
                          defines: str = "") -> None:
    """One turn of ``--decode-kernels``: the ``decoders``' readings (comma-
    separated) of the checkout at ``tree`` on the streams under ``path``;
    each of the comma-separated ``defines`` sets a constant of the two
    decode sources (``_use_variant``) or a table size of
    ``ops/vbyte_decode.py`` or ``ops/cgr_decode.py``
    (``SVB_TILE_QUADS=112``)."""
    decoders = decoders.split(",")
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
    from graphaibench_tpu_torch.ops import _build

    for name, value in _use_variant(defines, ("vbyte_decode.cu",
                                              "cgr_decode.cu")):
        mods = [m for m in (K11, K12) if hasattr(m, name)]
        if not mods:
            raise SystemExit(f"no constant {name} in the decode sources, "
                             "ops/vbyte_decode.py or ops/cgr_decode.py")
        setattr(mods[0], name, int(value))
    res = {"tree": tree, "defines": defines,
           "ptxas": _ptxas(("vbyte_decode", "cgr_decode"))}
    here = lambda name: os.path.exists(os.path.join(  # noqa: E731
        path, name + ".meta.json"))
    if here("vgb"):
        res["vgb_tags"] = _vgb_reading(
            C, DD, K11, load_compressed(os.path.join(path, "vgb")))
        res["vgb_col"] = res["vgb_tags"].pop("col")
        res["vgb_values"] = res["vgb_tags"].pop("values")
    if here("cgrp"):
        res["cgr_residual"] = _cgr_plain_reading(
            C, CD, K12, load_compressed(os.path.join(path, "cgrp")))
        res["cgrp_col"] = res["cgr_residual"].pop("col")
    if here("hybrid") and "res" in decoders:
        res["cgr_residual_hybrid"] = _hybrid_low_reading(
            C, DD, K12, load_compressed(os.path.join(path, "hybrid")))
        res["hybrid_col"] = res["cgr_residual_hybrid"].pop("col")
    if here("cgr"):
        res["cgr_merge"] = _cgr_reading(
            C, CD, K12, load_compressed(os.path.join(path, "cgr")))
        res["cgr_col"] = res["cgr_merge"].pop("col")
    if here("svb"):
        res["svb_decode"] = _svb_reading(
            C, DD, K11, load_compressed(os.path.join(path, "svb")), False)
        res["svb_col"] = res["svb_decode"].pop("col")
    if here("hybrid") and "svb" in decoders:
        res["svb_decode_hybrid"] = _svb_reading(
            C, DD, K11, load_compressed(os.path.join(path, "hybrid")), True)
        res["hybrid_col"] = res["svb_decode_hybrid"].pop("col")
    print("DECODE " + json.dumps(res))


def _state_bound(C, dg, active) -> tuple:
    """K14's bound on one round: chip_smoke._first_fit_bound's bytes with
    the ids of the active rows alone read (an inactive row keeps its
    colour), against one compare an id."""
    ids = int(dg.deg.long()[active].sum())
    nv = dg.nv
    return C._bound_of(4 * (nv + 1) + 4 * ids + 9 * nv, ids)


def _solve_reading(C, COL, dg) -> dict:
    """One warm solve under torch.profiler: K14's device ms a round (its
    launches in order), every kernel's device ms by name over the solve,
    and the rounds' active rows; asked up to five times while the profiler
    hands back fewer K14 launches than rounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    want, counts = C._color_rounds(dg)
    if not torch.equal(want, COL.color(dg)):
        raise SystemExit("the probe's loop and color() disagree")
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            colors, _ = C._color_rounds(dg)
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        k14 = [e.time_range.elapsed_us() / 1e3 for e in ev
               if "first_fit" in e.name]
        if len(k14) == len(counts):
            break
    by = {}
    for e in ev:
        by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    span = (ev[-1].time_range.end - ev[0].time_range.start) / 1e3 if ev else 0
    return {"rounds": len(counts), "active": counts, "k14_ms": k14,
            "k14_launches_read": len(k14), "k14_sum_ms": sum(k14),
            "k14_round1_ms": k14[0] if k14 else None,
            "k14_later_sum_ms": sum(k14[1:]),
            "device_ms_by_name": dict(sorted(by.items(),
                                             key=lambda kv: -kv[1])),
            "device_busy_ms": sum(by.values()),
            "device_span_ms": span,
            "colors": _digest(colors),
            "num_colors": int(colors.max()) + 1}


def _gamma_reading(C, K12, stream, pos, kind: int) -> dict:
    """cgr_gamma at ``pos`` against its plain version, with its device ms,
    batch ms and bound (the positions read, both outputs written, the
    codes' bits read once; OPS_PER_CODE a code), and how sorted ``pos``
    is."""
    import torch

    fn = lambda: K12.cgr_gamma(stream, pos, kind)  # noqa: E731
    got = fn()
    want = K12.cgr_gamma_plain(stream, pos, kind)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise SystemExit(f"cgr_gamma kind {kind} differs from plain in "
                             f"{int((a != b).sum())} of {a.numel()}")
    n = pos.numel()
    p = pos.long()
    bits = float((got[1].long() - p).sum())
    codes = n + (int((got[0] != 0).sum()) if kind == K12.HEADER_DEG else 0)
    out = _pass_ms(C, fn, "cgr_gamma", whole=False)
    out["bound_ms"], out["bound_by"], out["bound_bytes"] = C._bound_of(
        12 * n + bits / 8, codes * C.OPS_PER_CODE)
    out["share_of_bound"] = (out["bound_ms"] / out["device_ms"]
                             if out["device_ms"] else None)
    out["positions"] = n
    out["ascending"] = float((p[1:] >= p[:-1]).float().mean()) if n > 1 else 1.0
    spans = {}
    for tile in (256, 1024):
        m = n // tile * tile
        if m:
            q = p[:m].view(-1, tile)
            words = (q.max(1).values - q.min(1).values) // 32 + 3
            spans[tile] = {f"<= {kb} KB": float((words * 4 <= kb * 1024)
                                                .float().mean())
                           for kb in (8, 16, 32)}
    out["tile_spans"] = spans
    out["value"], out["next"] = _digest(got[0]), _digest(got[1])
    return out


def first_fit_worker(tree: str, path: str, defines: str = "") -> None:
    """One turn of ``--first-fit``: K14 and ``cgr_gamma`` of the checkout
    at ``tree`` on the graph and the streams under ``path``, built with the
    constants ``defines`` (``_use_variant``)."""
    sys.path.insert(0, ROOT)                 # chip_smoke's bounds
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as C
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.analytics import coloring as COL
    from graphaibench_tpu_torch.compress import cgr_device as CD
    from graphaibench_tpu_torch.compress.cli import load_compressed
    from graphaibench_tpu_torch.ops import cgr_decode as K12
    from graphaibench_tpu_torch.ops import first_fit as FF
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph

    import graphaibench_tpu_torch
    assert graphaibench_tpu_torch.__file__.startswith(os.path.abspath(tree))
    for name, value in _use_variant(defines, ("coloring.cu",
                                              "cgr_decode.cu")):
        mods = [m for m in (FF, K12) if hasattr(m, name)]
        if not mods:
            raise SystemExit(f"no constant {name} in coloring.cu, "
                             "cgr_decode.cu, ops/first_fit.py or "
                             "ops/cgr_decode.py")
        setattr(mods[0], name, int(value))
    res = {"tree": tree, "defines": defines,
           "ptxas": _ptxas(("coloring", "cgr_decode"))}
    z = np.load(os.path.join(path, "graph.npz"))
    g = CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"])
    dg = to_device_graph(g, device="cuda", with_transpose=False,
                         with_ell=False)
    res["hubs"] = int((g.degrees() > 1024).sum())
    res["states"] = {}
    for name, colors, active, mc in C._first_fit_states(dg, 3):
        fn = lambda: FF.first_fit(dg, colors, active, mc)  # noqa: E731
        if not torch.equal(fn(), FF.first_fit_plain(dg, colors, active, mc)):
            raise SystemExit(f"K14 differs from plain on {name}")
        by = C._device_ms_by_name(fn, KERNEL_CALLS)
        st = {"device_ms": sum(v for k, v in by.items() if "first_fit" in k),
              "by_name": by, "batch_ms": C._batch_ms(fn),
              "active": int(active.sum())}
        st["bound_ms"], st["bound_by"], st["bound_bytes"] = _state_bound(
            C, dg, active)
        st["share_of_bound"] = st["bound_ms"] / st["device_ms"]
        res["states"][name] = st
    res["solve"] = _solve_reading(C, COL, dg)
    res["solve"]["warm_s"] = C._solve_seconds(lambda: COL.color(dg),
                                              SOLVES_WARM)
    res["colors"] = res["solve"]["colors"]
    res["rounds"] = res["solve"]["rounds"]
    del dg
    torch.cuda.empty_cache()
    preps = {tag: CD.cgr_device_prep(load_compressed(os.path.join(path, tag)),
                                     device="cuda")
             for tag in ("cgr", "cgr_deg", "cgr_itv")}
    plain, deg, itv = preps["cgr"], preps["cgr_deg"], preps["cgr_itv"]
    ilanes = itv["itv_lanes"]
    _, _, ipfin = K12.cgr_interval(itv["stream"], *ilanes,
                                   int(itv["left"].numel()),
                                   itv["min_itv_len"])
    # the residual headers' positions as the interval prep finds them
    nsegs = np.bincount(ilanes[2].cpu().numpy(), minlength=itv["nv"])
    last = np.clip(np.cumsum(nsegs) - 1, 0, None)
    res_pos = np.where(nsegs > 0, ipfin.cpu().numpy()[last], 0)
    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).cuda()
    cases = {
        "header": (plain["stream"], plain["bit_off"], K12.HEADER),
        "header_deg": (deg["stream"], deg["bit_off"], K12.HEADER_DEG),
        "count": (plain["stream"], i32(plain["seg_start"]), K12.COUNT),
        "res_pos": (itv["stream"], i32(res_pos), K12.HEADER),
        "res_pos_shuffled": (itv["stream"], i32(
            res_pos[np.random.default_rng(0).permutation(len(res_pos))]),
            K12.HEADER),
    }
    res["cgr_gamma"] = {name: _gamma_reading(C, K12, *args)
                        for name, args in cases.items()}
    res["gamma_outputs"] = {name: [r.pop("value"), r.pop("next")]
                            for name, r in res["cgr_gamma"].items()}
    print("FIRST_FIT " + json.dumps(res))


def pull_kernels(parent: str | None, scale: int, variants=()) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat

    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, f"rmat{scale}.npz")
        g = rmat(scale, 16, seed=0, cache=False)
        np.savez(npz, row_ptr=g.row_ptr, col_idx=g.col_idx)
        del g
        _turns(parent, "--pull-kernels-worker", npz, "PULL",
               agree=("digests",), variants=variants)


def decode_kernels(parent: str | None, scales, decoders,
                   variants=()) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat
    from graphaibench_tpu_torch.compress import cgr, hybrid, vbyte
    from graphaibench_tpu_torch.compress.cli import save_compressed
    from graphaibench_tpu_torch.graph.transforms import sort_and_clean

    encoders = {
        "vgb": {"vgb": lambda g: vbyte.encode_graph(g, "varintgb")},
        "cgr": {"cgr": lambda g: cgr.encode_graph(
            g, C.CGR_STREAMS["interval"])},
        "svb": {"svb": lambda g: vbyte.encode_graph(g, "streamvbyte"),
                "hybrid": lambda g: hybrid.encode_graph(
                    g, threshold=HYBRID_THRESHOLD)},
        "res": {"cgrp": lambda g: cgr.encode_graph(g, C.CGR_STREAMS["plain"]),
                "hybrid": lambda g: hybrid.encode_graph(
                    g, threshold=HYBRID_THRESHOLD)},
    }
    unknown = set(decoders) - set(encoders)
    if unknown:
        raise SystemExit(f"unknown decoders {sorted(unknown)}: of "
                         f"{sorted(encoders)}")
    cols = {"vgb": ("vgb_col",), "cgr": ("cgr_col",),
            "svb": ("svb_col", "hybrid_col"),
            "res": ("cgrp_col", "hybrid_col")}
    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        for scale in scales:
            t0 = time.perf_counter()
            d = os.path.join(tmp, f"rmat{scale}")
            g = sort_and_clean(rmat(scale, 16, seed=0, cache=False))
            streams = {n: e for dec in decoders
                       for n, e in encoders[dec].items()}
            for name, enc in streams.items():
                save_compressed(enc(g), os.path.join(d, name))
            del g
            print(f"rmat({scale}, 16) encoded in "
                  f"{time.perf_counter() - t0:.1f} s")
            _turns(parent, "--decode-kernels-worker", d, "DECODE",
                   agree=tuple(dict.fromkeys(
                       c for dec in decoders for c in cols[dec])),
                   variants=variants, args=(",".join(decoders),))


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


def first_fit(parent: str | None, scale: int, variants=()) -> None:
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from graphaibench_tpu_torch import rmat
    from graphaibench_tpu_torch.compress import cgr
    from graphaibench_tpu_torch.compress.cli import save_compressed
    from graphaibench_tpu_torch.graph.transforms import sort_and_clean

    C.phase_device()         # the card's name and power limit
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        g = rmat(scale, 16, seed=0, cache=False)
        np.savez(os.path.join(tmp, "graph.npz"), row_ptr=g.row_ptr,
                 col_idx=g.col_idx)
        gs = sort_and_clean(g)
        del g
        for name, cfg in (("cgr", C.CGR_STREAMS["plain"]),
                          ("cgr_deg", cgr.CgrConfig(add_degree=True)),
                          ("cgr_itv", C.CGR_STREAMS["interval"])):
            save_compressed(cgr.encode_graph(gs, cfg), os.path.join(tmp, name))
        del gs
        print(f"rmat({scale}, 16) written and encoded in "
              f"{time.perf_counter() - t0:.1f} s")
        _turns(parent, "--first-fit-worker", tmp, "FIRST_FIT",
               agree=("colors", "rounds", "gamma_outputs"),
               variants=variants)


def _turns(parent: str | None, worker: str, path: str, tag: str,
           agree=(), variants=(), args=()) -> None:
    """Run ``worker`` on ``path`` with the change alone, or with the
    parents (``parent``, checkouts split by ``,``), the change twice and
    the parents in reverse, each turn given ``args`` after ``path``; print
    each turn's ``tag`` line. The keys in
    ``agree`` must be equal in every turn. With ``variants`` (constants,
    comma-separated, a string each), a turn of each variant comes between
    the change's two."""
    first = None
    order = ([("change", ROOT, "")] + [("change", ROOT, v) for v in variants]
             + [("change", ROOT, "")])
    if not parent and not variants:
        order = order[:1]
    parents = [("parent", p, "") for p in (parent or "").split(",") if p]
    order = parents + order + parents[::-1]
    for name, tree, defines in order:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), worker, tree, path,
             *args, *([defines] if defines else [])],
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
    ap.add_argument("--decoders", default="vgb,cgr,svb,res",
                    help="with --decode-kernels: the readings to take, of "
                    "vgb, cgr, svb and res")
    ap.add_argument("--pull-kernels", action="store_true",
                    help="K8 over each pull solve, a sweep of each case and "
                    "split by row class, at rmat19 (or --scale)")
    ap.add_argument("--variants", default="",
                    help="with --pull-kernels, --decode-kernels or "
                    "--first-fit: turns "
                    "of the change with these constants of its sources "
                    "(NAME=VALUE; or, for the decode, table sizes of "
                    "ops/vbyte_decode.py), ';' between variants, ',' "
                    "between the choices of one")
    ap.add_argument("--first-fit", action="store_true",
                    help="K14 on three states and over a color solve, and "
                    "K12's cgr_gamma on its four launch kinds, at rmat19 "
                    "(or --scale)")
    ap.add_argument("--first-fit-worker", nargs="+", metavar="ARG",
                    help=argparse.SUPPRESS)
    ap.add_argument("--pull-kernels-worker", nargs="+",
                    metavar="ARG", help=argparse.SUPPRESS)
    ap.add_argument("--parent", help="with --tc-cold, --tc-stream-mem, "
                    "--kernels, --decode-kernels, --pull-kernels or "
                    "--first-fit: "
                    "root of the parent commit's checkout (several split "
                    "by ',')")
    ap.add_argument("--tc-cold-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--kernels-worker", nargs=2, metavar=("TREE", "NPZ"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--decode-kernels-worker", nargs="+",
                    metavar="ARG", help=argparse.SUPPRESS)
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
        decode_kernels(args.parent, [args.scale] if args.scale else [19, 17],
                       [d for d in args.decoders.split(",") if d],
                       [v for v in args.variants.split(";") if v])
        return 0
    if args.first_fit_worker:
        first_fit_worker(*args.first_fit_worker)
        return 0
    if args.first_fit:
        first_fit(args.parent, args.scale or 19,
                  [v for v in args.variants.split(";") if v])
        return 0
    if args.pull_kernels_worker:
        pull_kernels_worker(*args.pull_kernels_worker)
        return 0
    if args.pull_kernels:
        pull_kernels(args.parent, args.scale or 19,
                     [v for v in args.variants.split(";") if v])
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
