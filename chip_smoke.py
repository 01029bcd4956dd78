#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. device  — requires a CUDA device; prints the nvidia-smi name and power
             limit line and torch's device name.
2. build   — compiles the four sources of ``graphaibench_tpu_torch/csrc``
             (``ell_spmm.cu``: K1; ``fused_gat.cu``: the five passes of
             the fused GAT attention v2; ``ell_edge.cu``: the three passes
             over per-edge values that v1 runs on; ``ell_pull.cu``: K8,
             ``neighbor_reduce``, the analytics' pull step) with nvcc,
             side by side, and loads them; prints the build seconds and
             the compiler's register report for each kernel.
3. kernel  — K1: on rmat(17, 16) with self-loops, for F in {128, 16} and both
             weight views (forward and transpose), holds the kernel
             against its plain PyTorch version and times both, beside the
             card's bound for the same work and the library call
             (torch.sparse.mm on a CSR tensor of the same graph and
             weights), which is timed here and used nowhere in the port.
             Then F = 7 (the kernel's scalar instantiation), and the
             graph without self-loops, which has rows of degree 0, behind
             an allocator dirtied with NaN: both against the plain version.
             The GAT passes (gat_rowmax, gat_v2_fwd, gat_v2_bwd_sl,
             gat_v2_bwd_h, and gat_v2_bwd, the backward in one pass): the
             same graph, F in {128, 16}, each kernel against its plain
             version on the same inputs, timed beside its bound (no
             single PyTorch call computes any of them, so there is no
             library time); then F = 7, 256 and 33 (float columns,
             several tiles, both) and the graph without self-loops
             behind the dirtied allocator; then the whole
             differentiable op, output and three gradients, against the
             port's unfused path (sddmm_add, segment_softmax, spmm) under
             autograd at rmat13.
             The passes over per-edge values (ell_row_reduce in its three
             kinds, gat_v1_fwd, sddmm_dot_ell): the same graph with a
             random 0/1 mask as edge weights, F in {128, 16}, each kernel
             against its plain version, timed beside its bound and, where
             one PyTorch call computes the same function (index_add_,
             scatter_reduce_, torch.sparse.sampled_addmm), that call;
             gat_v1_fwd also with the scores it writes for the backward;
             then F = 7, 33, 12 and 256 (float columns, more columns than
             a group has lanes, a group with an idle lane, several
             columns a lane and several tiles) and the graph without
             self-loops behind the dirtied allocator; then the v1 op
             (gat_attention_spmm), output and three gradients, against
             the unfused path at rmat13.
4. small   — the port's Model trained 5 steps on the GPU and on the CPU
             (plain versions) at rmat11 (ELL forced) and rmat13, for gcn,
             sage, gat and ggnn; the trajectories must agree. Then
             train_sampled for gcn (COO strategy) and gat (dense
             strategy) and inductive training for gat, GPU against CPU,
             and a save/restore round trip on the card.
5. main    — the GCN main path: Model(make_config("gcn", 2, 128, 128, 16,
             lr=0.01), ds, device="cuda").train(5) on rmat17, then
             evaluate("test"); counts the kernel's launches. Then the GAT
             main path at the same widths (2 layers, 128/128/16, no
             l2norm/dense head), with the GAT kernels' launch counts (per
             step gat_rowmax and gat_v2_fwd twice, gat_v2_bwd once, for the
             hidden layer, gat_v2_bwd_sl and gat_v2_bwd_h once, for the
             output layer; 4 in evaluation, no K1 launch), then sage at
             those widths and ggnn (make_config("ggnn", 1, 128, 128, 16))
             with K1's counts. Then 5 GAT steps at the same widths through
             apply_model with its default trivial_w and a random 0/1 mask
             as edge weights (the v1 fused attention): per step 10
             ell_row_reduce, 2 gat_v1_fwd, 2 sddmm_dot_ell and 2 K1
             launches. Then 5 epochs of train_sampled each for gcn and gat
             at subg_size 32768 (COO strategy, l2norm + dense head), with
             the sampler-wait, step and evaluation seconds of OpTimers
             and the launches of its two full-graph evaluations. Every
             count is set to 0 just before its path and read just
             after.
6. epochs  — the GCN and the GAT model on after those 5 warm-up steps:
             the median of 20 epochs with the kernels, and with their
             plain versions swapped in, in the order kernel, plain,
             plain, kernel.
7. profile — 10 more epochs of each under torch.profiler: device time per
             epoch by kernel, and the device's busy share of the profiled
             wall time (the profiler slows the host, so that share is a
             floor). The v1 path (20 timed steps, 10 profiled) and the
             sampled paths (3 profiled epochs) are profiled inside the
             main phase, right after they are driven.
8. analytics — on rmat(19, 16) (symmetric, the JAX package's analytics
             size): K8 against its plain version in every case (each kind
             for int32 and float32 vals, float32 also with edge values
             packed and as an (ne,) array), three cases timed beside the
             bound and, for the float32 sum, torch.sparse.mm (an SpMV);
             then every case at rmat13 behind an allocator dirtied with
             NaN. Then, every count set to 0 just before them, bfs,
             sssp_bellman_ford with symmetric and with asymmetric weights,
             pagerank, connected_components and the Afforest route, each
             held to scipy or a float64 numpy power iteration, with
             seconds per warm solve, sweeps and K8 launches (one a sweep);
             one BFS under the profiler. Then bfs and bfs_frontier on
             grid2d(512), a directed rmat13 through bfs_host's push route,
             and ``cli analytics bfs|sssp|pr|cc`` in four processes on a
             dataset written by the port's save_graph. Prints its seconds.
9. result  — a JSON line of the ten kernels, then the last line
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from graphaibench_tpu_torch import GnnDataset, rmat
from graphaibench_tpu_torch.analytics import cc as CCM
from graphaibench_tpu_torch.analytics import pr as PRM
from graphaibench_tpu_torch.analytics import traversal as TR
from graphaibench_tpu_torch.graph.generators import grid2d
from graphaibench_tpu_torch.graph.io import save_graph
from graphaibench_tpu_torch.graph.transforms import is_symmetric
from graphaibench_tpu_torch.nn import Model, make_config
from graphaibench_tpu_torch.nn.layers import apply_model
from graphaibench_tpu_torch.nn.losses import masked_softmax_loss
from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import ell_edge as EE
from graphaibench_tpu_torch.ops import ell_pull as K8
from graphaibench_tpu_torch.ops import ell_spmm as K1
from graphaibench_tpu_torch.ops import fused_gat as FG
from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.ops.device_graph import pack_edge_values, to_device_graph
from graphaibench_tpu_torch.ops.segment import segment_softmax
from graphaibench_tpu_torch.ops.spmm import sddmm_add, spmm
from graphaibench_tpu_torch.utils.timers import OP_EVAL, OP_SAMPLE, OP_STEP, OpTimers

SCALE, EDGE_FACTOR = 17, 16
FEAT, HIDDEN, CLASSES = 128, 128, 16
EPOCHS = 5
BUCKETS = 5              # widths 4, 8, 16, 32, 64 at rmat17
# One SpMM is one kernel launch over all buckets.
SPMMS_PER_STEP = 3       # two forward, one adjoint (layer 1's input is constant)
SPMMS_PER_EVAL = 2
# Kernel vs plain: the kernel adds split rows' pieces (degree > 64) with
# atomics, in an order that changes from run to run, and sums each row in
# another order than the plain version's reduction; both are float32.
# Rows that are not split are stored, not added, and repeat bit for bit.
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# The GAT passes against their plain versions: the same float32 reordering
# (a lane sums its columns' products over the slots before the group adds
# its lanes; atomics on split rows). A hub row sums thousands of terms of
# the size of the largest outputs, and the error of a float32 sum grows
# with the size of its terms, so the absolute tolerance is 1e-4 of the
# largest |plain| value (at least 1e-4); the row max is exact.
GAT_RTOL = GAT_ATOL_SCALE = 1e-4
GAT_KERNELS = {   # name -> line of the JAX pass it replaces
    "gat_rowmax": 285, "gat_v2_fwd": 309, "gat_v2_bwd_sl": 391,
    "gat_v2_bwd_h": 413, "gat_v2_bwd": 373}     # 373: both passes, _v2_bwd
GAT_WIDTHS = (7, 256, 33)   # untimed, behind the dirtied allocator
GAT_SMALL_SCALE = 13     # the whole op against the unfused path
EDGE_KERNELS = {  # name -> file:line of the JAX program it replaces
    "ell_row_reduce": "graphaibench_tpu/ops/segment.py:16",
    "gat_v1_fwd": "graphaibench_tpu/ops/fused_gat.py:36",
    "sddmm_dot_ell": "graphaibench_tpu/ops/spmm.py:307"}
MASK_KEEP = 0.7          # share of edges the random 0/1 mask keeps
EDGE_WIDTHS = (7, 33, 12, 256)   # untimed, behind the dirtied allocator
# Launches of one v1 GAT step per layer: forward the row max, the row sum
# of exp and gat_v1_fwd; backward K1 (dx), sddmm_dot_ell, the softmax
# adjoint's row sum, and the two row sums of sddmm_add's adjoint.
V1_ROW_REDUCES_PER_LAYER = (2, 3)      # forward, backward
SUBG_SIZE = 32768        # sampled main path: n_pad > 4096, the COO strategy
SAMPLED_VAL_INTERVAL = 2  # evaluations after epochs 2 and 4
SAMPLED_PROFILED_EPOCHS = 3
# Launches of the GAT main path (2 layers): per layer one gat_rowmax and
# one gat_v2_fwd forward; backward, by the size rule of
# ops/fused_gat.py::_single_pass, one gat_v2_bwd for the hidden layer
# (F = 128) and one gat_v2_bwd_sl and one gat_v2_bwd_h for the output layer
# (F = 16).
GAT_LAYERS = 2
GAT_STEP_LAUNCHES = {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS,
                     "gat_v2_bwd": 1, "gat_v2_bwd_sl": 1, "gat_v2_bwd_h": 1}
# The card's published peaks (H100 SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Small-model trajectories, GPU vs CPU: the same float32 reordering,
# compounded over 5 Adam steps.
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5
TIMED_CALLS = 20         # back-to-back calls between one pair of events
TIMED_BATCHES = 7
TIMED_EPOCHS = 20
PROFILED_EPOCHS = 10
# The analytics phase: the JAX package's analytics size, rmat(19, 16)
# symmetric; K8 also behind a dirtied allocator at rmat13; the
# high-diameter grid; a directed input; the CLI on a small dataset.
ANALYTICS_SCALE = 19
PULL_DIRTY_SCALE = 13
PULL_REPLACES = "graphaibench_tpu/ops/segment.py:124"
# K8 against its plain version: min, max and int32 sums exact; a float32
# sum adds in another order (atomics on split rows, in an order that
# changes from run to run): rtol 1e-5, atol 1e-6 of the largest |plain|.
PULL_FSUM_RTOL = 1e-5
PULL_FSUM_ATOL_SCALE = 1e-6
PULL_TIMED = ("float32 min packed", "int32 min", "float32 sum")
PULL_HEAD = "float32 sum"          # the timed case with a library call
SOLVES = 3                         # warm solves timed after the checked one
SSSP_RTOL = 1e-5                   # run_benchmark's tolerance
PR_L1 = 1e-4                       # the solver's epsilon
GRID_SIDE = 512
DIRECTED_SCALE = 13
CLI_KERNELS = ("bfs", "sssp", "pr", "cc")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device 0: {name}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load_library(name)
    dt = time.perf_counter() - t0
    print(f"[build] {[so.name for so in libs.values()]} in {dt:.2f} s")
    for name, so in libs.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")


def _batch_ms(fn, calls: int = TIMED_CALLS,
              batches: int = TIMED_BATCHES) -> float:
    """Device time of one call: ``calls`` back-to-back calls between one
    pair of events, divided by the count; the median of ``batches``. One
    event pair per call would read the host's enqueue for a kernel this
    short. The inputs stay as the last call left them in L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _kernel_device_ms(fn, kernel: str, calls: int = TIMED_CALLS):
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the mean over ``calls`` calls of ``fn`` under
    torch.profiler. ``_batch_ms`` reads the host's enqueue instead where a
    call's host work (allocating and initialising outputs, the ctypes
    call) outlasts a short kernel. The profiler now and then hands back
    no device event for so short a trace, so it is asked up to three
    times; None when none came back."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if us:
            return statistics.mean(us) / 1e3
    return None


def _bound(dg, f: int) -> tuple[float, str, int]:
    """The least time the card could take for one SpMM at width ``f``,
    in ms, what bounds it, and the bytes: x read once, the slot ids and
    weights, row ids and split flags read once, the output written once,
    over the memory rate; against 2 FLOP per slot and feature over the
    float32 rate. Slots count the ELL layout's padding: it is the input."""
    slots = sum(b.nbr.numel() for b in dg.ell)
    rows = sum(b.rows for b in dg.ell)
    nbytes = 2 * dg.nv * f * 4 + slots * 8 + rows * 4 + dg.nv
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * slots * f / F32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", nbytes


def _compare(dg, w, x, what: str, dirty: bool = False) -> float:
    """Max |kernel - plain| on one input; raises beyond the tolerance.
    With ``dirty``, the allocator's free block of the output's size is
    filled with NaN first, so a row the kernel does not write shows."""
    if dirty:
        junk = torch.full((dg.nv, x.shape[1]), float("nan"), device="cuda")
        del junk
    out_k = K1.ell_spmm(dg, w, x)
    out_p = K1.ell_spmm_plain(dg, w, x)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.allclose(out_k, out_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"kernel disagrees with plain at {what}: "
                           f"max |diff| {err}")
    again = K1.ell_spmm(dg, w, x)
    unsplit = dg.is_split == 0
    if not torch.equal(again[unsplit], out_k[unsplit]):
        raise RuntimeError(f"unsplit rows did not repeat bit for bit at {what}")
    return err


def phase_kernel(g) -> tuple[list[dict], float]:
    gp = prepare_graph(g, "gcn")
    dg = to_device_graph(gp, device="cuda")
    raw = torch.from_numpy(aggregation_weights(gp, "gcn")).cuda()
    wp = pack_edge_values(dg, raw)
    slots = sum(b.nbr.numel() for b in dg.ell)
    print(f"[kernel] rmat{SCALE} nv={dg.nv} ne={dg.ne} slots={slots} "
          f"buckets={[(b.width, b.rows) for b in dg.ell]} "
          f"split_rows={int(dg.is_split.sum())} zero_rows={dg.zero_rows.numel()}")
    if len(dg.ell) != BUCKETS:
        raise RuntimeError(f"expected {BUCKETS} buckets, got {len(dg.ell)}")
    # the library call's operands: the same graph and weights as one CSR
    # tensor per view (the graph is symmetric, so the transpose has the
    # same structure and the permuted weights)
    csr = {view: torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx, vals,
                                         size=(dg.nv, dg.nv))
           for view, vals in (("fwd", raw), ("t", raw[dg.trans_perm.long()]))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for f in (FEAT, CLASSES):
        x = torch.randn(dg.nv, f, device="cuda", generator=gen)
        bound_ms, bound_by, nbytes = _bound(dg, f)
        for view in ("fwd", "t"):
            w = getattr(wp, view)
            err = _compare(dg, w, x, f"F={f} view={view}")
            if not w.launch_table.vec_ok:
                raise RuntimeError("the main path's buckets must take the "
                                   "kernel's vector instantiation")
            out_l = torch.sparse.mm(csr[view], x)
            if not torch.allclose(out_l, K1.ell_spmm_plain(dg, w, x),
                                  rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                raise RuntimeError(f"torch.sparse.mm disagrees with plain at "
                                   f"F={f} view={view}")
            ms = _batch_ms(lambda: K1.ell_spmm(dg, w, x))
            plain_ms = _batch_ms(lambda: K1.ell_spmm_plain(dg, w, x),
                                 calls=5, batches=3)
            library_ms = _batch_ms(lambda: torch.sparse.mm(csr[view], x))
            device_ms = _kernel_device_ms(lambda: K1.ell_spmm(dg, w, x),
                                          "ell_spmm_kernel")
            case = {"F": f, "view": view, "tile": K1._tile_floats(dg.nv, f),
                    "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_bytes": nbytes, "share_of_bound": bound_ms / ms,
                    "edges_per_s": dg.ne / (ms * 1e-3)}
            print(f"[kernel] {json.dumps(case)}")
            cases.append(case)
    # F = 7 takes the kernel's scalar instantiation (F % 4 != 0)
    x7 = torch.randn(dg.nv, 7, device="cuda", generator=gen)
    err7 = _compare(dg, wp.fwd, x7, "F=7 (scalar)", dirty=True)
    print(f"[kernel] F=7 scalar instantiation: max_abs_err {err7}, "
          f"{_batch_ms(lambda: K1.ell_spmm(dg, wp.fwd, x7)):.4f} ms")
    # no self-loops (the SAGE preparation): rows of degree 0 have no
    # virtual row, so only the wrapper's zeroing covers them
    gs = prepare_graph(g, "sage")
    dgs = to_device_graph(gs, device="cuda")
    empty = int((dgs.deg == 0).sum())
    if empty == 0:
        raise RuntimeError("the graph without self-loops has no row of "
                           "degree 0: the case checks nothing")
    wps = pack_edge_values(dgs, torch.from_numpy(
        aggregation_weights(gs, "sage")).cuda())
    errs = []
    for f in (CLASSES, 7):
        xs = torch.randn(dgs.nv, f, device="cuda", generator=gen)
        for view in ("fwd", "t"):
            errs.append(_compare(dgs, getattr(wps, view), xs,
                                 f"no self-loops F={f} view={view}", dirty=True))
    print(f"[kernel] no self-loops: {empty} rows of degree 0, "
          f"{dgs.zero_rows.numel()} zeroed rows, dirtied allocator, "
          f"F in (16, 7) x (fwd, t): max_abs_err {max(errs)}")
    return cases, max(err7, *errs)


def _gat_close(got, want, what: str) -> float:
    """Max |kernel - plain|; raises beyond rtol 1e-4 and an absolute
    tolerance of 1e-4 of the largest |plain| (at least 1e-4)."""
    err = float((got - want).abs().max())
    atol = GAT_ATOL_SCALE * max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{what}: the kernel's output is not finite")
    if not torch.allclose(got, want, rtol=GAT_RTOL, atol=atol):
        raise RuntimeError(f"{what}: kernel disagrees with plain, "
                           f"max |diff| {err} (atol {atol})")
    return err


def _gat_bounds(dg, f: int) -> dict[str, tuple[float, str, int]]:
    """Per GAT pass: the least time the card could take, in ms, what
    bounds it, and the bytes. Bytes: every input read once and every
    output written once — the ids of the real slots (the passes skip the
    pads), the row ids, valid counts and split flags, the (nv,) vectors
    and the (nv, F) matrices. Operations: per real slot the multiply-adds
    over F and some ten scalar ones (exp counted as one)."""
    rows = sum(b.rows for b in dg.ell)
    ids = dg.ne * 4 + rows * 8 + dg.nv
    vec, mat = dg.nv * 4, dg.nv * f * 4
    work = {
        "gat_rowmax": (ids + 2 * vec, dg.ne),
        "gat_v2_fwd": (ids + 4 * vec + 2 * mat, dg.ne * (2 * f + 6)),
        "gat_v2_bwd_sl": (ids + 6 * vec + 2 * mat, dg.ne * (2 * f + 10)),
        "gat_v2_bwd_h": (ids + 6 * vec + 3 * mat, dg.ne * (4 * f + 12)),
        # as gat_v2_bwd_h, and d_sl written
        "gat_v2_bwd": (ids + 7 * vec + 3 * mat, dg.ne * (4 * f + 13)),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / F32_FLOP_PER_S * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations", nbytes)
    return out


def _gat_passes(dg, f: int, gen, what: str, dirty: bool, timed: bool):
    """The five kernels against their plain versions on one graph and
    width, each on the same inputs (the later passes take the plain
    forward's m, zinv and out). Returns {name: case}."""
    nv = dg.nv
    sl = torch.randn(nv, device="cuda", generator=gen)
    sr = torch.randn(nv, device="cuda", generator=gen)
    h = torch.randn(nv, f, device="cuda", generator=gen)
    ct = torch.randn(nv, f, device="cuda", generator=gen)

    def run(fn, *args):
        if dirty:   # a row the kernel does not write shows as NaN
            junk = [torch.full((nv, f), float("nan"), device="cuda"),
                    torch.full((nv,), float("nan"), device="cuda")]
            del junk
        return fn(dg, *args)

    m0_p = FG.gat_rowmax_plain(dg, sr)
    m0 = run(FG.gat_rowmax, sr)
    if not torch.equal(m0, m0_p):
        raise RuntimeError(f"{what}: gat_rowmax differs from plain")
    m = FG._leaky(sl + torch.where(torch.isfinite(m0_p), m0_p,
                                   torch.zeros_like(m0_p)))
    acc_p, z_p = FG.gat_v2_fwd_plain(dg, sl, sr, m, h)
    acc, z = run(FG.gat_v2_fwd, sl, sr, m, h)
    zinv = 1.0 / torch.clamp(z_p, min=FG.Z_FLOOR)
    inner = (ct * acc_p * zinv[:, None]).sum(1)
    bwd = (sl, sr, m, zinv, inner, h, ct)
    d_sl_p = FG.gat_v2_bwd_sl_plain(dg, *bwd)
    d_sl = run(FG.gat_v2_bwd_sl, *bwd)
    d_h_p, d_sr_p = FG.gat_v2_bwd_h_plain(dg, *bwd)
    d_h, d_sr = run(FG.gat_v2_bwd_h, *bwd)
    one = run(FG.gat_v2_bwd, *bwd)
    one_p = FG.gat_v2_bwd_plain(dg, *bwd)
    torch.cuda.synchronize()
    errs = {
        "gat_rowmax": 0.0,
        "gat_v2_fwd": max(_gat_close(acc, acc_p, f"{what} acc"),
                          _gat_close(z, z_p, f"{what} z")),
        "gat_v2_bwd_sl": _gat_close(d_sl, d_sl_p, f"{what} d_sl"),
        "gat_v2_bwd_h": max(_gat_close(d_h, d_h_p, f"{what} d_h"),
                            _gat_close(d_sr, d_sr_p, f"{what} d_sr")),
        "gat_v2_bwd": max(
            _gat_close(got, want, f"{what} single pass {name}")
            for got, want, name in zip(one, one_p, ("d_sl", "d_sr", "d_h"))),
    }
    # the single pass's plain version against the two passes' plain versions
    for got, want, name in zip(one_p, (d_sl_p, d_sr_p, d_h_p),
                               ("d_sl", "d_sr", "d_h")):
        _gat_close(got, want, f"{what} plain single pass {name}")
    cases = {name: {"F": f, "max_abs_err": err} for name, err in errs.items()}
    for name in GAT_KERNELS:
        if name != "gat_rowmax":
            rule = (FG._fwd_tile_floats if name == "gat_v2_fwd"
                    else FG._bwd_tile_floats)
            cases[name]["tile"] = rule(nv, f) if f % 4 == 0 else min(f, 32)
    if not timed:
        return cases
    calls = {
        "gat_rowmax": (FG.gat_rowmax, FG.gat_rowmax_plain, (sr,)),
        "gat_v2_fwd": (FG.gat_v2_fwd, FG.gat_v2_fwd_plain, (sl, sr, m, h)),
        "gat_v2_bwd_sl": (FG.gat_v2_bwd_sl, FG.gat_v2_bwd_sl_plain, bwd),
        "gat_v2_bwd_h": (FG.gat_v2_bwd_h, FG.gat_v2_bwd_h_plain, bwd),
        "gat_v2_bwd": (FG.gat_v2_bwd, FG.gat_v2_bwd_plain, bwd),
    }
    bounds = _gat_bounds(dg, f)
    for name, (kernel, plain, args) in calls.items():
        ms = _batch_ms(lambda: kernel(dg, *args))
        # the single pass is gat_v2_bwd_h's kernel with d_sl to add into
        device_ms = _kernel_device_ms(
            lambda: kernel(dg, *args),
            f"{'gat_v2_bwd_h' if name == 'gat_v2_bwd' else name}_kernel")
        plain_ms = _batch_ms(lambda: plain(dg, *args), calls=3, batches=3)
        bound_ms, bound_by, nbytes = bounds[name]
        cases[name].update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms,
            bound_by=bound_by, bound_bytes=nbytes,
            share_of_bound=bound_ms / ms, edges_per_s=dg.ne / (ms * 1e-3))
        print(f"[kernel] {name} {json.dumps(cases[name])}")
    return cases


def _gat_unfused(dg, sl, sr, h):
    logits = gmath.leaky_relu(sddmm_add(dg, sl, sr), 0.2)
    return spmm(dg, segment_softmax(dg, logits), h, "ell")


def phase_gat_kernels(g) -> dict[str, dict]:
    """{kernel: {"cases": [timed cases], "max_abs_err": over every case}}."""
    dg = to_device_graph(prepare_graph(g, "gat"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {name: {"cases": [], "max_abs_err": 0.0} for name in GAT_KERNELS}

    def fold(cases, timed):
        for name, case in cases.items():
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                           case["max_abs_err"])
            if timed:
                res[name]["cases"].append(case)

    for f in (FEAT, CLASSES):
        fold(_gat_passes(dg, f, gen, f"F={f}", dirty=False, timed=True), True)
    # F = 7: float columns; 256: two tiles; 33: float columns in two tiles
    for f in GAT_WIDTHS:
        fold(_gat_passes(dg, f, gen, f"F={f}", dirty=True, timed=False), False)
    dgs = to_device_graph(prepare_graph(g, "sage"), device="cuda")
    if int((dgs.deg == 0).sum()) == 0:
        raise RuntimeError("the graph without self-loops has no row of "
                           "degree 0: the case checks nothing")
    for f in (CLASSES, 7):
        fold(_gat_passes(dgs, f, gen, f"no self-loops F={f}", dirty=True,
                         timed=False), False)
    print(f"[kernel] GAT passes at F in {GAT_WIDTHS} and on the graph "
          f"without self-loops ({int((dgs.deg == 0).sum())} rows of degree 0, dirtied "
          f"allocator): max_abs_err "
          f"{ {n: r['max_abs_err'] for n, r in res.items()} }")

    # the whole differentiable op against the port's unfused path
    gs = prepare_graph(rmat(GAT_SMALL_SCALE, 8, seed=1), "gat")
    dg13 = to_device_graph(gs, device="cuda")
    ct = torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)
    outs = []
    base = [torch.randn(dg13.nv, device="cuda", generator=gen),
            torch.randn(dg13.nv, device="cuda", generator=gen),
            torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)]
    # the op as its size rule runs it here (two backward passes), with the
    # single pass forced, and the unfused path
    rule = FG._single_pass
    for fn, single in ((FG.gat_attention_spmm_v2, False),
                       (FG.gat_attention_spmm_v2, True), (_gat_unfused, False)):
        sl, sr, h = (t.clone().requires_grad_(True) for t in base)
        FG._single_pass = (lambda nv, f: True) if single else rule
        try:
            out = fn(dg13, sl, sr, h)
            (out * ct).sum().backward()
        finally:
            FG._single_pass = rule
        outs.append((out.detach(), sl.grad, sr.grad, h.grad))
    errs = [max(_gat_close(a, c, f"fused vs unfused {what}"),
                _gat_close(b, c, f"fused (single pass) vs unfused {what}"))
            for a, b, c, what in zip(*outs, ("out", "d_sl", "d_sr", "d_h"))]
    print(f"[kernel] gat_attention_spmm_v2 (backward in two passes and in "
          f"one) vs the unfused path at rmat{GAT_SMALL_SCALE} F={CLASSES}: "
          f"max_abs_err out/d_sl/d_sr/d_h {errs}")
    return res


def _edge_bounds(dg, f: int) -> dict[str, tuple[float, str, int]]:
    """Per pass over per-edge values: the least time the card could take,
    in ms, what bounds it, and the bytes. Bytes: every input read once and
    every output written once — per real slot its edge id and, for the two
    wide passes, its neighbour id (the passes skip the pads), the row ids
    and valid counts, the split flags where rows are combined, the (ne,)
    and (nv,) vectors and the (nv, F) matrices. Operations: per real slot
    the multiply-adds over F and a few scalar ones (exp counted as one)."""
    rows = sum(b.rows for b in dg.ell)
    eids = dg.ne * 4 + rows * 8
    evec, vec, mat = dg.ne * 4, dg.nv * 4, dg.nv * f * 4
    work = {
        "ell_row_reduce max": (eids + dg.nv + evec + vec, dg.ne),
        "ell_row_reduce sum": (eids + dg.nv + evec + vec, dg.ne),
        "ell_row_reduce sumexp": (eids + dg.nv + evec + 2 * vec, 2 * dg.ne),
        "gat_v1_fwd": (eids + dg.ne * 4 + dg.nv + 2 * evec + 2 * vec + 2 * mat,
                       dg.ne * (2 * f + 4)),
        "gat_v1_fwd with scores": (
            eids + dg.ne * 4 + dg.nv + 3 * evec + 2 * vec + 2 * mat,
            dg.ne * (2 * f + 4)),
        "sddmm_dot_ell": (eids + dg.ne * 4 + 2 * mat + evec, dg.ne * 2 * f),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / F32_FLOP_PER_S * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations", nbytes)
    return out


def _edge_passes(dg, f: int, gen, what: str, dirty: bool, timed: bool,
                 reduces: bool = True):
    """The three kernels of csrc/ell_edge.cu against their plain versions
    on one graph and width, each on the same inputs (gat_v1_fwd takes the
    plain passes' m and zinv, and is held to its plain version with and
    without the scores), with a random 0/1 mask as edge weights.
    Returns {case name: case}; ``reduces`` says whether ell_row_reduce,
    which does not depend on F, is among them."""
    nv, ne = dg.nv, dg.ne
    logits = 2.0 * torch.randn(ne, device="cuda", generator=gen)
    mask = (torch.rand(ne, device="cuda", generator=gen) < MASK_KEEP).float()
    x = torch.randn(nv, f, device="cuda", generator=gen)
    ct = torch.randn(nv, f, device="cuda", generator=gen)

    def run(fn, *args):
        if dirty:   # an element the kernel does not write shows as NaN
            junk = [torch.full((nv, f), float("nan"), device="cuda"),
                    torch.full((nv,), float("nan"), device="cuda"),
                    torch.full((ne,), float("nan"), device="cuda")]
            del junk
        return fn(dg, *args)

    m_p = EE.ell_row_reduce_plain(dg, logits, "max")
    m = torch.where(torch.isfinite(m_p), m_p, torch.zeros_like(m_p))
    z_p = EE.ell_row_reduce_plain(dg, logits, "sumexp", m)
    zinv = 1.0 / torch.clamp(z_p, min=FG.Z_FLOOR)
    errs = {}
    if reduces:
        if not torch.equal(run(EE.ell_row_reduce, logits, "max"), m_p):
            raise RuntimeError(f"{what}: ell_row_reduce max differs from plain")
        errs["ell_row_reduce max"] = 0.0
        errs["ell_row_reduce sum"] = _gat_close(
            run(EE.ell_row_reduce, logits, "sum"),
            EE.ell_row_reduce_plain(dg, logits, "sum"), f"{what} row sum")
        errs["ell_row_reduce sumexp"] = _gat_close(
            run(EE.ell_row_reduce, logits, "sumexp", m), z_p,
            f"{what} row sumexp")
    v1 = (logits, mask, x, m, zinv)
    out_p, scores_p = EE.gat_v1_fwd_plain(dg, *v1, True)
    errs["gat_v1_fwd"] = _gat_close(run(EE.gat_v1_fwd, *v1), out_p,
                                    f"{what} gat_v1_fwd")
    out_s, scores = run(EE.gat_v1_fwd, *v1, True)
    errs["gat_v1_fwd with scores"] = max(
        _gat_close(out_s, out_p, f"{what} gat_v1_fwd beside its scores"),
        _gat_close(scores, scores_p, f"{what} gat_v1_fwd's scores"))
    raw_p = EE.sddmm_dot_ell_plain(dg, ct, x)
    errs["sddmm_dot_ell"] = _gat_close(run(EE.sddmm_dot_ell, ct, x), raw_p,
                                       f"{what} sddmm_dot_ell")
    torch.cuda.synchronize()
    cases = {name: {"F": f, "max_abs_err": err} for name, err in errs.items()}
    if not timed:
        return cases
    # the one PyTorch call that computes the same function, where there is
    # one; timed here and used nowhere on a CUDA graph with ELL buckets
    src = dg.edge_src.long()
    pattern = torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx,
                                      torch.zeros(ne, device="cuda"),
                                      size=(nv, nv))
    xt = x.t().contiguous()
    library = {
        "ell_row_reduce max": lambda: torch.full(
            (nv,), float("-inf"), device="cuda").scatter_reduce_(
                0, src, logits, "amax"),
        "ell_row_reduce sum": lambda: torch.zeros(nv, device="cuda").index_add_(
            0, src, logits),
        "sddmm_dot_ell": lambda: torch.sparse.sampled_addmm(
            pattern, ct, xt, beta=0.0),
    }
    for name, want in (("ell_row_reduce max", m_p),
                       ("ell_row_reduce sum",
                        EE.ell_row_reduce_plain(dg, logits, "sum")),
                       ("sddmm_dot_ell", raw_p)):
        got = library[name]()
        got = got.values() if got.layout == torch.sparse_csr else got
        _gat_close(got, want, f"{what} library call for {name}")
    calls = {
        "ell_row_reduce max": (EE.ell_row_reduce, EE.ell_row_reduce_plain,
                               (logits, "max")),
        "ell_row_reduce sum": (EE.ell_row_reduce, EE.ell_row_reduce_plain,
                               (logits, "sum")),
        "ell_row_reduce sumexp": (EE.ell_row_reduce, EE.ell_row_reduce_plain,
                                  (logits, "sumexp", m)),
        "gat_v1_fwd": (EE.gat_v1_fwd, EE.gat_v1_fwd_plain, v1),
        "gat_v1_fwd with scores": (EE.gat_v1_fwd, EE.gat_v1_fwd_plain,
                                   (*v1, True)),
        "sddmm_dot_ell": (EE.sddmm_dot_ell, EE.sddmm_dot_ell_plain, (ct, x)),
    }
    bounds = _edge_bounds(dg, f)
    for name in cases:
        kernel, plain, args = calls[name]
        ms = _batch_ms(lambda: kernel(dg, *args))
        device_ms = _kernel_device_ms(lambda: kernel(dg, *args),
                                      f"{name.split()[0]}_kernel")
        plain_ms = _batch_ms(lambda: plain(dg, *args), calls=3, batches=3)
        library_ms = _batch_ms(library[name]) if name in library else None
        bound_ms, bound_by, nbytes = bounds[name]
        cases[name].update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_bytes=nbytes, share_of_bound=bound_ms / ms,
            edges_per_s=ne / (ms * 1e-3))
        if name.startswith("gat_v1") or name.startswith("sddmm"):
            cases[name]["tile"] = (EE._v1_tile_floats(nv, f)
                                   if name.startswith("gat_v1") else f)
        print(f"[kernel] {name} {json.dumps(cases[name])}")
    return cases


def _v1_unfused(dg, logits, w, x):
    return spmm(dg, segment_softmax(dg, logits) * w, x, "ell")


def phase_edge_kernels(g) -> dict[str, dict]:
    """{kernel: {"cases": [timed cases], "max_abs_err": over every case}}
    for ell_row_reduce (cases: its three kinds), gat_v1_fwd (cases: F = 128
    and 16, each without and with the scores) and sddmm_dot_ell (cases:
    F = 128 and 16)."""
    dg = to_device_graph(prepare_graph(g, "gat"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {name: {"cases": [], "max_abs_err": 0.0} for name in EDGE_KERNELS}

    def fold(cases, timed):
        for name, case in cases.items():
            kernel = name.split()[0]
            res[kernel]["max_abs_err"] = max(res[kernel]["max_abs_err"],
                                             case["max_abs_err"])
            if timed:
                res[kernel]["cases"].append(dict(case, case=name))

    for f in (FEAT, CLASSES):
        fold(_edge_passes(dg, f, gen, f"F={f}", dirty=False, timed=True,
                          reduces=f == FEAT), True)
    # F = 7 and 33: float columns, 33 more of them than a group has lanes;
    # 12: three columns of V in a group of four lanes; 256: more float4
    # columns a lane than sddmm_dot_ell keeps in registers, two tiles for
    # gat_v1_fwd
    for f in EDGE_WIDTHS:
        fold(_edge_passes(dg, f, gen, f"F={f}", dirty=True, timed=False,
                          reduces=f == EDGE_WIDTHS[0]), False)
    dgs = to_device_graph(prepare_graph(g, "sage"), device="cuda")
    empty = int((dgs.deg == 0).sum())
    if empty == 0:
        raise RuntimeError("the graph without self-loops has no row of "
                           "degree 0: the case checks nothing")
    for f in (CLASSES, 7):
        fold(_edge_passes(dgs, f, gen, f"no self-loops F={f}", dirty=True,
                          timed=False), False)
    print(f"[kernel] passes over per-edge values at F in {EDGE_WIDTHS} and on "
          f"the graph without self-loops ({empty} rows of degree 0, dirtied allocator, "
          f"0/1 mask): max_abs_err "
          f"{ {n: r['max_abs_err'] for n, r in res.items()} }")

    # the v1 op and its three gradients against the port's unfused path
    dg13 = to_device_graph(prepare_graph(rmat(GAT_SMALL_SCALE, 8, seed=1),
                                         "gat"), device="cuda")
    ct = torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)
    base = [torch.randn(dg13.ne, device="cuda", generator=gen),
            (torch.rand(dg13.ne, device="cuda", generator=gen)
             < MASK_KEEP).float(),
            torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)]
    outs = []
    for fn in (FG.gat_attention_spmm, _v1_unfused):
        l, w, x = (t.clone().requires_grad_(True) for t in base)
        out = fn(dg13, l, w, x)
        (out * ct).sum().backward()
        outs.append((out.detach(), l.grad, w.grad, x.grad))
    errs = [_gat_close(a, b, f"v1 fused vs unfused {what}")
            for a, b, what in zip(*outs, ("out", "d_logits", "d_edge_w", "d_x"))]
    print(f"[kernel] gat_attention_spmm (v1, 0/1 mask) vs the unfused path at "
          f"rmat{GAT_SMALL_SCALE} F={CLASSES}: max_abs_err "
          f"out/d_logits/d_edge_w/d_x {errs}")
    return res


def _dataset(g, feat: int, classes: int, seed: int = 0) -> GnnDataset:
    """bench.py's in-memory dataset shape: normal features, uniform
    labels, train on the first half, validate/test on the second."""
    rng = np.random.default_rng(seed)
    nv = g.nv
    half = nv // 2
    ones = np.ones(nv, dtype=np.uint8)
    return GnnDataset(
        graph=g, feats=rng.standard_normal((nv, feat)).astype(np.float32),
        labels=rng.integers(0, classes, nv).astype(np.int32),
        train_mask=ones, val_mask=ones, test_mask=ones, num_classes=classes,
        train_range=(0, half, half), val_range=(half, nv, nv - half),
        test_range=(half, nv, nv - half))


def phase_small() -> None:
    for arch in ("gcn", "sage", "gat", "ggnn"):
        for scale, impl in ((11, "ell"), (13, "auto")):
            ds = _dataset(rmat(scale, 8, seed=1), 32, 4)
            cfg = make_config(arch, 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
            runs = {}
            for dev in ("cuda", "cpu"):
                m = Model(cfg, ds, device=dev)
                log = m.train(EPOCHS, verbose=False)
                params = [p.detach().cpu().numpy()
                          for p in m.params.parameters()]
                runs[dev] = (np.array([(l, a) for l, a, _ in log]), params)
            np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
            for pc, pp in zip(runs["cuda"][1], runs["cpu"][1]):
                np.testing.assert_allclose(pc, pp, rtol=TRAJ_RTOL,
                                           atol=TRAJ_ATOL)
            print(f"[small] {arch} rmat{scale} spmm_impl={impl}: GPU losses "
                  f"{runs['cuda'][0][:, 0].tolist()} match the CPU run")


def _params_np(model) -> list:
    return [p.detach().cpu().numpy() for p in model.params.parameters()]


def _assert_same_run(a, b, what: str) -> None:
    """Two (trajectory, parameters) pairs within the trajectory tolerance."""
    np.testing.assert_allclose(a[0], b[0], rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                               err_msg=what)
    for pa, pb in zip(a[1], b[1]):
        np.testing.assert_allclose(pa, pb, rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                   err_msg=what)


def phase_small_trainer() -> None:
    """GPU against CPU for what the trainer does beyond full-batch steps:
    sampled training (gcn above 4096 padded vertices: the COO strategy;
    gat below: the dense one), inductive training, and a save/restore
    round trip on the card."""
    for arch, scale, subg in (("gcn", 13, 5000), ("gat", 11, 600)):
        ds = _dataset(rmat(scale, 8, seed=1), 32, 4)
        cfg = make_config(arch, 2, 32, 16, 4, lr=0.01, subg_size=subg)
        runs = {}
        for dev in ("cuda", "cpu"):
            m = Model(cfg, ds, device=dev, inductive=True)
            log = m.train_sampled(3, subg, verbose=False, seed=5)
            runs[dev] = (np.array([(l, a) for l, a, _ in log]), _params_np(m))
        _assert_same_run(runs["cuda"], runs["cpu"], f"sampled {arch}")
        print(f"[small] train_sampled {arch} rmat{scale} subg_size={subg}: GPU "
              f"losses {runs['cuda'][0][:, 0].tolist()} match the CPU run")

    g = rmat(13, 8, seed=1)
    ds = _dataset(g, 32, 4)
    ds.train_mask = (np.arange(g.nv) % 3 != 0).astype(np.uint8)
    cfg = make_config("gat", 2, 32, 16, 4, lr=0.01)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = Model(cfg, ds, device=dev, inductive=True)
        log = m.train(EPOCHS, verbose=False)
        runs[dev] = (np.array([(l, a) for l, a, _ in log]), _params_np(m))
    _assert_same_run(runs["cuda"], runs["cpu"], "inductive gat")
    print(f"[small] inductive gat rmat13 (training graph ne="
          f"{m.training.host.ne} of {m.full.host.ne}): GPU losses "
          f"{runs['cuda'][0][:, 0].tolist()} match the CPU run")

    # save after 2 steps, restore into a fresh Model, 2 more: the state
    # comes back bit for bit, and the run goes on as the uninterrupted
    # one within the trajectory tolerance (split rows are added with
    # atomics, so two runs on the card are not bit-equal)
    cfg = make_config("gcn", 2, 32, 16, 4, lr=0.01)
    whole = Model(cfg, ds, device="cuda")
    want = whole.train(4, verbose=False)
    first = Model(cfg, ds, device="cuda")
    got = first.train(2, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = first.save(tmp, step=2)
        second = Model(cfg, ds, device="cuda")
        second.restore(tmp, step=2)
    for a, b in zip(first.params.parameters(), second.params.parameters()):
        if not (torch.equal(a, b) and b.is_cuda):
            raise RuntimeError("restore did not bring the parameters back")
    saved, back = first.opt.state_dict(), second.opt.state_dict()
    for name in ("m", "v"):
        if not all(torch.equal(a, b) for a, b in zip(saved[name], back[name])):
            raise RuntimeError(f"restore did not bring Adam's {name} back")
    if float(saved["b1_t"]) != float(back["b1_t"]):
        raise RuntimeError("restore did not bring Adam's b1_t back")
    got += second.train(2, verbose=False)
    _assert_same_run((np.array([(l, a) for l, a, _ in got]), _params_np(second)),
                     (np.array([(l, a) for l, a, _ in want]), _params_np(whole)),
                     "save/restore")
    print(f"[small] save/restore on the card ({path.rsplit('/', 1)[-1]}): 2 + 2 "
          f"steps match 4 uninterrupted steps")


def _zero_counts() -> None:
    K1.LAUNCHES = 0
    for counts in (FG.LAUNCHES, EE.LAUNCHES, K8.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _counts() -> dict[str, int]:
    return {"ell_spmm": K1.LAUNCHES, **FG.LAUNCHES, **EE.LAUNCHES,
            **K8.LAUNCHES}


def _drive(g, cfg, want_train: dict, want_eval: dict):
    """One main path: set-up, every launch count set to 0, ``EPOCHS``
    training steps, the counts read, evaluation, the counts read again.
    Raises unless the losses are finite and fall, the logits are finite
    and of shape (nv, classes), and each kernel was launched as often as
    the design implies (``want_*``: per step and per evaluation; a kernel
    not named must not be launched). Returns (model, launches)."""
    tag = f"[main {cfg.arch}]"
    ds = _dataset(g, cfg.dim_init, cfg.num_cls)
    t0 = time.perf_counter()
    model = Model(cfg, ds, device="cuda")
    torch.cuda.synchronize()
    print(f"{tag} Model set-up {time.perf_counter() - t0:.2f} s "
          f"(nv={model.full.device.nv} ne={model.full.device.ne})")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    log = model.train(EPOCHS)
    train = _counts()
    acc = model.evaluate("test")
    total = _counts()
    losses = [l for l, _, _ in log]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag} non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} loss did not decrease: {losses}")
    for name, n in total.items():
        want_t = EPOCHS * want_train.get(name, 0)
        want_e = want_eval.get(name, 0)
        if train[name] != want_t or n - train[name] != want_e:
            raise RuntimeError(
                f"{tag} {name}: {train[name]} launches in training and "
                f"{n - train[name]} in evaluate, expected {want_t} and "
                f"{want_e}")
    if not 0.0 <= acc <= 1.0:
        raise RuntimeError(f"{tag} test accuracy {acc} outside [0, 1]")
    with torch.no_grad():
        logits = apply_model(model.cfg, model.params, model.full.device,
                             model.full.edge_w_agg, model.feats,
                             trivial_w=True)
    if tuple(logits.shape) != (g.nv, cfg.num_cls) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"{tag} bad logits: shape {tuple(logits.shape)}")
    epoch_ms = statistics.median(dt for _, _, dt in log) * 1e3
    print(f"{tag} losses {losses} test_acc {acc:.4f}")
    print(f"{tag} launches in training {train}, with evaluation {total}; "
          f"epoch median {epoch_ms:.3f} ms (warm-up epochs included); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, total


def phase_main(g):
    """The GCN path, then this port's other three architectures at the
    same widths. Returns the GCN and GAT models and the launch counts of
    their paths."""
    gcn, n_gcn = _drive(
        g, make_config("gcn", 2, FEAT, HIDDEN, CLASSES, lr=0.01),
        {"ell_spmm": SPMMS_PER_STEP}, {"ell_spmm": SPMMS_PER_EVAL})
    gat, n_gat = _drive(
        g, make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES, lr=0.01,
                       use_l2norm=False, use_dense=False),
        GAT_STEP_LAUNCHES,
        {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS})
    # SAGE: as GCN, 3 SpMMs a step (layer 1's input is constant). GGNN
    # with dim_init == dim_hid does not project: one SpMM of the constant
    # features a step, no adjoint.
    _drive(g, make_config("sage", 2, FEAT, HIDDEN, CLASSES, lr=0.01),
           {"ell_spmm": SPMMS_PER_STEP}, {"ell_spmm": SPMMS_PER_EVAL})
    _drive(g, make_config("ggnn", 1, FEAT, HIDDEN, CLASSES, lr=0.01),
           {"ell_spmm": 1}, {"ell_spmm": 1})
    launches = {"ell_spmm": n_gcn["ell_spmm"],
                **{name: n_gat[name] for name in GAT_KERNELS}}
    return gcn, gat, launches


def _assert_counts(tag: str, got: dict, want: dict) -> None:
    """Every kernel launched as often as ``want`` says; one not named,
    not at all."""
    for name, n in got.items():
        if n != want.get(name, 0):
            raise RuntimeError(f"{tag} {name}: {n} launches, expected "
                               f"{want.get(name, 0)} (all counts: {got})")


def phase_main_v1(g) -> tuple[dict[str, int], dict]:
    """The v1 main path: ``EPOCHS`` GAT steps at full width through
    ``apply_model`` with its default ``trivial_w`` and a random 0/1 mask
    as edge weights, then one evaluation forward; then ``TIMED_EPOCHS``
    more steps on the host clock and ``PROFILED_EPOCHS`` under the
    profiler. Returns the launch counts of training and evaluation
    together, and the step's host-clock ms, device ms, device ops and the
    peak memory in GiB."""
    tag = "[main gat v1]"
    cfg = make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES, lr=0.01,
                      use_l2norm=False, use_dense=False)
    ds = _dataset(g, FEAT, CLASSES)
    model = Model(cfg, ds, device="cuda")
    dg = model.full.device
    gen = torch.Generator(device="cuda").manual_seed(3)
    mask = (torch.rand(dg.ne, device="cuda", generator=gen) < MASK_KEEP).float()
    begin, end, _ = ds.train_range
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, times = [], []

    def steps(n: int) -> None:
        for _ in range(n):
            t0 = time.perf_counter()
            model.opt.zero_grad()
            logits = apply_model(cfg, model.params, dg, mask, model.feats,
                                 train=True)
            loss, rep, _ = masked_softmax_loss(logits, model.labels, begin,
                                               end, model.masks["train"])
            loss.backward()
            model.opt.step()
            losses.append(float(rep.detach()))     # waits for the device
            times.append(time.perf_counter() - t0)

    steps(EPOCHS)
    train = _counts()
    fwd, bwd = V1_ROW_REDUCES_PER_LAYER
    _assert_counts(f"{tag} training", train, {
        "ell_row_reduce": EPOCHS * GAT_LAYERS * (fwd + bwd),
        "gat_v1_fwd": EPOCHS * GAT_LAYERS,
        "sddmm_dot_ell": EPOCHS * GAT_LAYERS,
        "ell_spmm": EPOCHS * GAT_LAYERS})       # K1: dx, once per layer
    with torch.no_grad():
        logits = apply_model(cfg, model.params, dg, mask, model.feats)
    total = _counts()
    _assert_counts(f"{tag} evaluation",
                   {k: total[k] - train[k] for k in total},
                   {"ell_row_reduce": GAT_LAYERS * fwd,
                    "gat_v1_fwd": GAT_LAYERS})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} losses not finite or not falling: {losses}")
    if tuple(logits.shape) != (g.nv, CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"{tag} bad logits: shape {tuple(logits.shape)}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} losses {losses}")
    print(f"{tag} launches in training {train}, with one evaluation forward "
          f"{total}; step median {statistics.median(times) * 1e3:.3f} ms "
          f"(warm-up steps included); peak memory {peak_gib:.4f} GiB")
    steps(TIMED_EPOCHS)
    step_ms = statistics.median(times[EPOCHS:]) * 1e3
    print(f"{tag} median of {TIMED_EPOCHS} more steps {step_ms:.4f} ms")
    device_ms, device_ops = phase_profile("gat v1", steps, PROFILED_EPOCHS,
                                          step_ms)
    return total, {"step_ms": step_ms, "device_ms": device_ms,
                   "device_ops": device_ops, "peak_gib": peak_gib}


def phase_main_sampled(g) -> None:
    """The sampled main path: ``EPOCHS`` epochs of ``train_sampled`` each
    for gcn and gat at full width, ``SUBG_SIZE`` vertices a subgraph,
    with the stage seconds of OpTimers and the launches of its full-graph
    evaluations (the sampled step itself runs on a graph without ELL
    buckets: plain PyTorch, no kernel of this port)."""
    evals = len(range(SAMPLED_VAL_INTERVAL, EPOCHS, SAMPLED_VAL_INTERVAL))
    per_eval = {"gcn": {"ell_spmm": SPMMS_PER_EVAL},
                "gat": {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS}}
    for arch in ("gcn", "gat"):
        tag = f"[main sampled {arch}]"
        cfg = make_config(arch, 2, FEAT, HIDDEN, CLASSES, lr=0.01,
                          subg_size=SUBG_SIZE)
        timers = OpTimers()
        t0 = time.perf_counter()
        model = Model(cfg, _dataset(g, FEAT, CLASSES), device="cuda",
                      inductive=True, timers=timers)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        log = model.train_sampled(EPOCHS, SUBG_SIZE,
                                  val_interval=SAMPLED_VAL_INTERVAL)
        counts = _counts()
        _assert_counts(tag, counts, {k: evals * n
                                     for k, n in per_eval[arch].items()})
        # every epoch trains on another subgraph (and the labels are
        # random), so the losses need not fall within 5 epochs
        losses = [l for l, _, _ in log]
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{tag} non-finite loss: {losses}")
        acc = model.evaluate("test")
        if not 0.0 <= acc <= 1.0:
            raise RuntimeError(f"{tag} test accuracy {acc} outside [0, 1]")
        if (timers.counts[OP_SAMPLE], timers.counts[OP_STEP],
                timers.counts[OP_EVAL]) != (EPOCHS, EPOCHS, evals + 1):
            raise RuntimeError(f"{tag} timer counts {dict(timers.counts)}")
        print(f"{tag} set-up {setup:.2f} s; losses {losses} test_acc {acc:.4f}; "
              f"launches of {evals} evaluations {counts}")
        epoch_ms = statistics.median(dt for _, _, dt in log) * 1e3
        print(f"{tag} epoch median {epoch_ms:.3f} ms; "
              f"OpTimers seconds over {EPOCHS} epochs: sampler wait "
              f"{timers.times[OP_SAMPLE]:.4f}, step {timers.times[OP_STEP]:.4f}, "
              f"evaluation x{evals + 1} {timers.times[OP_EVAL]:.4f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        phase_profile(f"sampled {arch}",
                      lambda n, m=model: m.train_sampled(
                          n, SUBG_SIZE, verbose=False, seed=EPOCHS),
                      SAMPLED_PROFILED_EPOCHS, epoch_ms)


class _plain_kernels:
    """While active, the wrappers send CUDA tensors to the kernels' plain
    versions (for timing the plain versions on the main path)."""

    def __enter__(self):
        self.saved = (K1._ell_spmm_cuda, FG.gat_rowmax, FG.gat_v2_fwd,
                      FG.gat_v2_bwd_sl, FG.gat_v2_bwd_h, FG.gat_v2_bwd)
        K1._ell_spmm_cuda = lambda table, x: K1.ell_spmm_plain(
            table.graph, table.w_slots, x)
        FG.gat_rowmax = FG.gat_rowmax_plain
        FG.gat_v2_fwd = FG.gat_v2_fwd_plain
        FG.gat_v2_bwd_sl = FG.gat_v2_bwd_sl_plain
        FG.gat_v2_bwd_h = FG.gat_v2_bwd_h_plain
        FG.gat_v2_bwd = FG.gat_v2_bwd_plain

    def __exit__(self, *exc):
        (K1._ell_spmm_cuda, FG.gat_rowmax, FG.gat_v2_fwd, FG.gat_v2_bwd_sl,
         FG.gat_v2_bwd_h, FG.gat_v2_bwd) = self.saved


def _epoch_median_ms(model, plain: bool) -> float:
    """Median epoch time over TIMED_EPOCHS, with the kernels or with
    their plain versions."""
    if plain:
        with _plain_kernels():
            log = model.train(TIMED_EPOCHS, verbose=False)
    else:
        log = model.train(TIMED_EPOCHS, verbose=False)
    if not all(np.isfinite([l for l, _, _ in log])):
        raise RuntimeError("non-finite loss in the timed epochs")
    return statistics.median(dt for _, _, dt in log) * 1e3


def phase_epochs(model) -> float:
    tag = f"[epochs {model.cfg.arch}]"
    runs = [(plain, _epoch_median_ms(model, plain))
            for plain in (False, True, True, False)]
    kernel = [ms for plain, ms in runs if not plain]
    plain = [ms for plain, ms in runs if plain]
    print(f"{tag} median of {TIMED_EPOCHS} epochs, kernel/plain/plain/"
          f"kernel: {[round(ms, 4) for _, ms in runs]} ms; kernel "
          f"{statistics.mean(kernel):.4f} ms, plain "
          f"{statistics.mean(plain):.4f} ms")
    return statistics.mean(kernel)


def phase_profile(tag: str, run, epochs: int, epoch_ms: float,
                  unit: str = "epoch"):
    """``run(epochs)`` under torch.profiler: device time per epoch by
    kernel and the device's busy share; ``epoch_ms`` is the unprofiled
    epoch on the host clock, from another run. Returns (device ms per
    epoch, device ops per epoch), or (None, None) without device events.
    ``unit`` names what ``run`` repeats in the printed lines."""
    from torch.profiler import ProfilerActivity, profile

    tag = f"[profile {tag}]"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(epochs)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"{tag} the profiler recorded no device events: device "
              "time and busy share not measured")
        return None, None
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)
    by_name: dict[str, list] = {}
    for e in dev:
        item = by_name.setdefault(e.name, [0, 0.0])
        item[0] += 1
        item[1] += e.time_range.elapsed_us()
    device_ms = busy / epochs / 1e3
    print(f"{tag} {epochs} {unit}s: device busy "
          f"{device_ms:.4f} ms/{unit}, {len(dev) / epochs:.1f} "
          f"device ops/{unit}, busy share {busy / wall_us:.4f} of the "
          f"profiled wall time; {device_ms / epoch_ms:.4f} of the unprofiled "
          f"{epoch_ms:.4f} ms {unit} (device time and wall time from two runs)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        print(f"{tag} {us / epochs / 1e3:.4f} ms/{unit} "
              f"{us / busy:.4f} of device time, {n / epochs:g}/{unit}: "
              f"{name[:90]}")
    return device_ms, len(dev) / epochs


# ---- the analytics phase ---------------------------------------------------

def _pull_bound(dg, edge_vals: bool) -> tuple[float, str, int]:
    """The least time the card could take for one neighbor_reduce, in ms,
    what bounds it, and the bytes: per real slot its neighbour id and, with
    edge values, its value (the pads are the layout's, not the function's);
    the row id and count of each virtual row; the split flags; vals read
    once and out written once. Against one operation a slot (two with edge
    values) over the float32 rate (int32 at that rate too: the card's int32
    rate is not in the data sheet)."""
    rows = sum(b.rows for b in dg.ell)
    nbytes = dg.ne * (8 if edge_vals else 4) + rows * 8 + dg.nv * 9
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = dg.ne * (2 if edge_vals else 1) / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def _pull_close(got, want, what: str) -> float:
    """Max |kernel - plain|: equal for min, max and int32 sums; a float32
    sum within rtol 1e-5 and an absolute 1e-6 of the largest |plain|."""
    if got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {got.dtype} against plain's {want.dtype}")
    if not what.startswith("float32 sum"):
        if not torch.equal(got, want):
            raise RuntimeError(f"{what}: neighbor_reduce differs from plain in "
                               f"{int((got != want).sum())} rows")
        return 0.0
    atol = PULL_FSUM_ATOL_SCALE * float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=PULL_FSUM_RTOL, atol=atol):
        raise RuntimeError(f"{what}: neighbor_reduce disagrees with plain, "
                           f"max |diff| {err} (atol {atol})")
    return err


def _pull_cases(dg, gen, what: str, dirty: bool, timed: bool) -> dict:
    """K8 against its plain version on one graph in every case: each kind
    for int32 and float32 vals, float32 also with edge values packed and
    as an (ne,) array. Returns {case: {"max_abs_err", and where timed the
    times beside the bound}}."""
    nv, ne = dg.nv, dg.ne
    vals = {"int32": torch.randint(-10**6, 10**6, (nv,), dtype=torch.int32,
                                   device="cuda", generator=gen),
            "float32": torch.randn(nv, device="cuda", generator=gen)}
    ev = torch.rand(ne, device="cuda", generator=gen) + 0.25
    packed = K8.pack_neighbor_edge_vals(dg, ev)
    forms = {"": None, " packed": packed, " flat": ev}
    specs = {f"{dtype} {kind}{form}": (vals[dtype], kind, e)
             for dtype in vals for kind in K8.KINDS for form, e in forms.items()
             if dtype == "float32" or e is None}
    cases = {}
    for name, (v, kind, e) in specs.items():
        if dirty:   # a row the kernel does not write shows as NaN
            junk = torch.full((nv,), float("nan"), device="cuda")
            del junk
        got = K8.neighbor_reduce(dg, v, kind, e)
        want = K8.neighbor_reduce_plain(dg, v, kind,
                                        None if e is None else packed)
        torch.cuda.synchronize()
        cases[name] = {"max_abs_err": _pull_close(got, want, name)}
    if not timed:
        return cases
    # the one PyTorch call that computes a float32 sum over the neighbours,
    # an SpMV of the graph's CSR matrix; timed here and used nowhere
    ones = torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx,
                                   torch.ones(ne, device="cuda"), size=(nv, nv))
    col = vals["float32"][:, None]
    library = {"float32 sum": lambda: torch.sparse.mm(ones, col)}
    _pull_close(library["float32 sum"]()[:, 0],
                K8.neighbor_reduce_plain(dg, vals["float32"], "sum"),
                "float32 sum: the library call")
    for name in PULL_TIMED:
        v, kind, e = specs[name]
        slots = None if e is None else packed
        ms = _batch_ms(lambda: K8.neighbor_reduce(dg, v, kind, e))
        device_ms = _kernel_device_ms(
            lambda: K8.neighbor_reduce(dg, v, kind, e), "neighbor_reduce_kernel")
        plain_ms = _batch_ms(lambda: K8.neighbor_reduce_plain(dg, v, kind, slots),
                             calls=3, batches=3)
        library_ms = _batch_ms(library[name]) if name in library else None
        bound_ms, bound_by, nbytes = _pull_bound(dg, e is not None)
        cases[name].update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_bytes=nbytes, share_of_bound=bound_ms / ms,
            edges_per_s=ne / (ms * 1e-3))
        print(f"[analytics] neighbor_reduce {name} {json.dumps(cases[name])}")
    return cases


def phase_pull_kernel(dg) -> dict:
    """K8 against its plain version at the analytics size (timed), then on
    rmat13 behind an allocator dirtied with NaN. Returns {"cases": the
    timed cases, "max_abs_err": over every case}."""
    split, empty = int(dg.is_split.sum()), int((dg.deg == 0).sum())
    print(f"[analytics] rmat{ANALYTICS_SCALE} nv={dg.nv} ne={dg.ne} "
          f"buckets={[(b.width, b.rows) for b in dg.ell]} split_rows={split} "
          f"edgeless_rows={empty}")
    if not split or not empty:
        raise RuntimeError("the analytics graph must have split and edgeless "
                           "rows: the cases would check less")
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = _pull_cases(dg, gen, f"rmat{ANALYTICS_SCALE}", dirty=False,
                        timed=True)
    small = to_device_graph(rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0),
                            device="cuda")
    dirty = _pull_cases(small, gen, f"rmat{PULL_DIRTY_SCALE}", dirty=True,
                        timed=False)
    err = max(c["max_abs_err"] for c in (*cases.values(), *dirty.values()))
    print(f"[analytics] neighbor_reduce: {len(cases)} cases at "
          f"rmat{ANALYTICS_SCALE} and {len(dirty)} at rmat{PULL_DIRTY_SCALE} "
          f"behind a NaN-dirtied allocator agree with plain, max_abs_err {err}")
    return {"cases": [dict(cases[n], case=n) for n in PULL_TIMED],
            "max_abs_err": err}


class _sweeps:
    """While active, counts the solvers' calls of neighbor_reduce: one a
    sweep of their pull route."""

    def __enter__(self):
        self.n = 0

        def counted(*args, **kw):
            self.n += 1
            return K8.neighbor_reduce(*args, **kw)

        for module in (TR, PRM, CCM):
            module.neighbor_reduce = counted
        return self

    def __exit__(self, *exc):
        for module in (TR, PRM, CCM):
            module.neighbor_reduce = K8.neighbor_reduce


def _scipy_csr(g, w=None):
    from scipy.sparse import csr_matrix

    data = np.ones(g.ne) if w is None else w.astype(np.float64)
    return csr_matrix((data, g.col_idx, g.row_ptr), shape=(g.nv, g.nv))


def _bfs_ref(g, source: int = 0) -> np.ndarray:
    """Depths from scipy, -1 where unreached."""
    from scipy.sparse.csgraph import shortest_path

    d = shortest_path(_scipy_csr(g), directed=True, unweighted=True,
                      indices=source)
    return np.where(np.isfinite(d), d, -1).astype(np.int32)


def _sssp_ref(g, w, source: int = 0) -> np.ndarray:
    from scipy.sparse.csgraph import dijkstra

    return dijkstra(_scipy_csr(g, w), directed=True, indices=source)


def _cc_ref(g) -> np.ndarray:
    """scipy's components, each named by its least vertex id."""
    from scipy.sparse.csgraph import connected_components

    _, lab = connected_components(_scipy_csr(g), directed=False)
    _, first = np.unique(lab, return_index=True)
    return first[lab].astype(np.int32)


def _pagerank_ref(g) -> tuple[np.ndarray, int]:
    """A float64 power iteration with the solver's rule and constants:
    new_i = (1 - d) / nv + d * sum over j in N(i) of s_j / max(deg_j, 1),
    until the L1 change falls below epsilon or after MAX_ITER."""
    nv = g.nv
    src = np.repeat(np.arange(nv), np.diff(g.row_ptr))
    deg = np.maximum(np.diff(g.row_ptr), 1)
    s = np.full(nv, 1.0 / nv)
    for it in range(1, PRM.MAX_ITER + 1):
        new = ((1 - PRM.K_DAMP) / nv + PRM.K_DAMP * np.bincount(
            src, weights=(s / deg)[g.col_idx], minlength=nv))
        err = np.abs(new - s).sum()
        s = new
        if err < PRM.EPSILON:
            break
    return s, it


def _solve(tag: str, ne: int | None, fn, check, solves: int = SOLVES) -> dict:
    """One solve held to its reference by ``check`` (which raises, or
    returns what to print), with its sweeps and neighbor_reduce launches;
    then ``solves`` timed ones (host clock, ending in a sync). ``ne``: the
    edges a sweep covers, for edges x sweeps / s (None: not one graph)."""
    with _sweeps() as sw:
        before = K8.LAUNCHES["neighbor_reduce"]
        out = fn()
        torch.cuda.synchronize()
        launches = K8.LAUNCHES["neighbor_reduce"] - before
    info = {"solver": tag, **check(out), "sweeps": sw.n, "launches": launches}
    if launches != sw.n:
        raise RuntimeError(f"[analytics] {tag}: {launches} neighbor_reduce "
                           f"launches in {sw.n} pull sweeps")
    times = []
    for _ in range(solves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    s = statistics.median(times)
    info.update(s_per_solve=s, edges_x_sweeps_per_s=(
        None if ne is None else ne * sw.n / s))
    print(f"[analytics] {json.dumps(info)}")
    return info


def _exact(got, want, what: str) -> None:
    if not np.array_equal(got, want):
        raise RuntimeError(f"[analytics] {what} differs from the reference in "
                           f"{int((got != want).sum())} vertices")


def phase_solvers(g, dg) -> int:
    """The solvers at the analytics size through the calls run_benchmark
    makes, each against a reference independent of both packages (scipy,
    numpy), timed; then one BFS under the profiler. Returns the
    neighbor_reduce launches of the checked and timed solves, every count
    set to 0 just before them."""
    nv, ne = g.nv, g.ne
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    # one weight per undirected edge: an edge and its reverse take the draw
    # at the lower edge id (trans_perm maps an edge to its reverse)
    rev = dg.trans_perm.cpu().numpy()
    w_sym = rng.uniform(0.1, 2.0, ne).astype(np.float32)[
        np.minimum(np.arange(ne), rev)]
    w_asym = rng.uniform(0.1, 2.0, ne).astype(np.float32)
    ref_bfs, ref_cc = _bfs_ref(g), _cc_ref(g)
    ref_sssp = {"symmetric": _sssp_ref(g, w_sym),
                "asymmetric": _sssp_ref(g, w_asym)}
    ref_pr, ref_iters = _pagerank_ref(g)
    print(f"[analytics] references (scipy, numpy float64) in "
          f"{time.perf_counter() - t0:.2f} s: reached {int((ref_bfs >= 0).sum())}, "
          f"depth {ref_bfs.max()}, {len(np.unique(ref_cc))} components, "
          f"pagerank {ref_iters} iterations")

    def check_bfs(dist):
        dist = dist.cpu().numpy()
        _exact(dist, ref_bfs, "bfs")
        return {"reached": int((dist >= 0).sum()), "max_depth": int(dist.max())}

    def check_sssp(kind):
        def check(dist):
            dist = dist.cpu().numpy()
            if not np.allclose(dist, ref_sssp[kind], rtol=SSSP_RTOL,
                               equal_nan=True):
                raise RuntimeError(f"[analytics] sssp ({kind} weights) differs "
                                   "from dijkstra beyond rtol 1e-5")
            return {"reached": int(np.isfinite(dist).sum())}
        return check

    def check_pr(res):
        scores, iters = res
        l1 = float(np.abs(scores.cpu().numpy() - ref_pr).sum())
        if l1 >= PR_L1 or abs(iters - ref_iters) > 1:
            raise RuntimeError(f"[analytics] pagerank: L1 {l1} from the float64 "
                               f"reference, {iters} iterations against {ref_iters}")
        return {"iterations": iters, "l1_from_float64": l1}

    def check_cc(comp):
        comp = comp if isinstance(comp, np.ndarray) else comp.cpu().numpy()
        _exact(comp, ref_cc, "cc")
        return {"components": int(len(np.unique(comp)))}

    weights = {k: torch.from_numpy(w).cuda()
               for k, w in (("symmetric", w_sym), ("asymmetric", w_asym))}
    _zero_counts()
    bfs = _solve("bfs", ne, lambda: TR.bfs(dg, 0), check_bfs)
    if bfs["sweeps"] != ref_bfs.max() + 1:
        raise RuntimeError(f"[analytics] bfs took {bfs['sweeps']} sweeps for "
                           f"depth {ref_bfs.max()}")
    for kind, w in weights.items():
        _solve(f"sssp_bellman_ford {kind} weights", ne,
               lambda w=w: TR.sssp_bellman_ford(dg, w, 0), check_sssp(kind))
    pr = _solve("pagerank", ne, lambda: PRM.pagerank(dg), check_pr)
    if pr["sweeps"] != pr["iterations"]:
        raise RuntimeError("[analytics] pagerank's sweeps are not its iterations")
    _solve("connected_components", ne, lambda: CCM.connected_components(dg),
           check_cc)
    _solve("connected_components_afforest", None,
           lambda: CCM.connected_components_afforest(g, device="cuda"), check_cc)
    counts = _counts()
    launches = counts["neighbor_reduce"]
    if launches == 0:
        raise RuntimeError("[analytics] the solvers launched no neighbor_reduce")
    _assert_counts("[analytics]", counts, {"neighbor_reduce": launches})
    print(f"[analytics] launches of the solves above {counts}")
    phase_profile(f"bfs rmat{ANALYTICS_SCALE}",
                  lambda n: [TR.bfs(dg, 0) for _ in range(n)], 1,
                  bfs["s_per_solve"] * 1e3, unit="solve")
    return launches


def phase_grid_and_directed() -> None:
    """The high-diameter grid through bfs and bfs_frontier, and a directed
    rmat through bfs_host, which takes the push route."""
    g = grid2d(GRID_SIDE)
    dg = to_device_graph(g, device="cuda", with_transpose=False)
    ref = _bfs_ref(g)

    def check(dist):
        # "sweeps" below counts the pull sweeps; bfs_frontier takes a
        # sparse (push) sweep for each other level
        _exact(dist.cpu().numpy(), ref, f"grid2d({GRID_SIDE}) bfs")
        return {"max_depth": int(ref.max()), "levels": int(ref.max()) + 1}

    for name, fn in (("bfs", TR.bfs), ("bfs_frontier", TR.bfs_frontier)):
        _solve(f"{name} grid2d({GRID_SIDE})", g.ne, lambda fn=fn: fn(dg, 0),
               check, solves=1)
    g = rmat(DIRECTED_SCALE, 8, seed=0, undirected=False)
    if is_symmetric(g):
        raise RuntimeError("the directed rmat came out symmetric")
    before = K8.LAUNCHES["neighbor_reduce"]
    dist = TR.bfs_host(g, 0, device="cuda")
    if K8.LAUNCHES["neighbor_reduce"] != before:
        raise RuntimeError("bfs_host pulled over a directed graph")
    _exact(dist, _bfs_ref(g), f"directed rmat{DIRECTED_SCALE} bfs_host")
    print(f"[analytics] directed rmat({DIRECTED_SCALE}, 8): bfs_host took the "
          f"push route (no ELL buckets, no neighbor_reduce launch), reached "
          f"{int((dist >= 0).sum())} of {g.nv}, equal to scipy")


def phase_analytics_cli() -> None:
    """``python -m graphaibench_tpu_torch.cli analytics <k> <dir> 0`` for
    the four solvers on a small dataset written by the port's save_graph,
    without --device, side by side: each must print ``device = cuda`` and
    ``Correct`` and exit 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "GAB_SHARDS"}
    with tempfile.TemporaryDirectory() as tmp:
        save_graph(rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0), tmp)
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "graphaibench_tpu_torch.cli", "analytics",
             k, tmp, "0"], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for k in CLI_KERNELS}
        try:
            outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for k, (out, err) in outs.items():
        lines = out.splitlines()
        if (procs[k].returncode != 0 or "device = cuda" not in lines
                or "Correct" not in lines):
            raise RuntimeError(f"cli analytics {k}: exit {procs[k].returncode}"
                               f"\n{out}\n{err[-3000:]}")
        runtime = next(l for l in lines if l.startswith("runtime"))
        print(f"[analytics] cli analytics {k} rmat{PULL_DIRTY_SCALE}: "
              f"device = cuda, Correct, {runtime}")
    print(f"[analytics] the four CLI runs side by side in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_analytics() -> dict:
    """K8 and the analytics solvers. Returns K8's entry data: its timed
    cases, its largest error and the launches of the solvers' path."""
    t0 = time.perf_counter()
    g = rmat(ANALYTICS_SCALE, EDGE_FACTOR, seed=0)
    t1 = time.perf_counter()
    dg = to_device_graph(g, device="cuda")
    torch.cuda.synchronize()
    print(f"[analytics] rmat({ANALYTICS_SCALE}, {EDGE_FACTOR}) generated in "
          f"{t1 - t0:.2f} s, on the card in {time.perf_counter() - t1:.2f} s")
    if not is_symmetric(g):
        raise RuntimeError("the analytics graph must be symmetric")
    pull = phase_pull_kernel(dg)
    launches = phase_solvers(g, dg)
    phase_grid_and_directed()
    phase_analytics_cli()
    print(f"[analytics] phase took {time.perf_counter() - t0:.2f} s")
    return dict(pull, launches=launches)


def main() -> None:
    name = phase_device()
    phase_build()
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGE_FACTOR, seed=0)
    print(f"[graph] rmat({SCALE}, {EDGE_FACTOR}) generated in "
          f"{time.perf_counter() - t0:.2f} s")
    cases, other_err = phase_kernel(g)
    gat_kernels = phase_gat_kernels(g)
    edge_kernels = phase_edge_kernels(g)
    phase_small()
    phase_small_trainer()
    gcn, gat, launches = phase_main(g)
    v1_launches, _ = phase_main_v1(g)
    phase_main_sampled(g)
    for model in (gcn, gat):
        phase_profile(model.cfg.arch,
                      lambda n, m=model: m.train(n, verbose=False),
                      PROFILED_EPOCHS, phase_epochs(model))
    pull = phase_analytics()
    head = cases[0]
    kernels = [{
        "name": "ell_spmm",
        "route": "cuda",
        "source": "graphaibench_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "graphaibench_tpu/ops/pallas_spmm.py:43",
        "launches": launches["ell_spmm"],
        "max_abs_err": max(other_err, *(c["max_abs_err"] for c in cases)),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": cases,
    }]
    for kname, line in GAT_KERNELS.items():
        res = gat_kernels[kname]
        head = res["cases"][0]      # F = 128, the hidden layer's width
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "graphaibench_tpu_torch/csrc/fused_gat.cu",
            "replaces": f"graphaibench_tpu/ops/fused_gat.py:{line}",
            "launches": launches[kname],
            "max_abs_err": res["max_abs_err"],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            # no single PyTorch call computes a pass of the fused attention
            "library_ms": None,
            "cases": res["cases"],
        })
    for kname, replaces in EDGE_KERNELS.items():
        res = edge_kernels[kname]
        # F = 128; for ell_row_reduce the sum, which has a library call
        head = next(c for c in res["cases"]
                    if c["case"] in ("ell_row_reduce sum", kname))
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "graphaibench_tpu_torch/csrc/ell_edge.cu",
            "replaces": replaces,
            "launches": v1_launches[kname],
            "max_abs_err": res["max_abs_err"],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "cases": res["cases"],
        })
    head = next(c for c in pull["cases"] if c["case"] == PULL_HEAD)
    kernels.append({
        "name": "neighbor_reduce",
        "route": "cuda",
        "source": "graphaibench_tpu_torch/csrc/ell_pull.cu",
        "replaces": PULL_REPLACES,
        "launches": pull["launches"],
        "max_abs_err": pull["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": pull["cases"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
