#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. device  — requires a CUDA device; prints the nvidia-smi name and power
             limit line and torch's device name.
2. build   — compiles K1 (``graphaibench_tpu_torch/csrc/ell_spmm.cu``)
             with nvcc and loads it; prints the build seconds and the
             compiler's register report.
3. kernel  — on rmat(17, 16) with self-loops, for F in {128, 16} and both
             weight views (forward and transpose), holds the kernel
             against its plain PyTorch version and times both, beside the
             card's bound for the same work and the library call
             (torch.sparse.mm on a CSR tensor of the same graph and
             weights), which is timed here and used nowhere in the port.
             Then F = 7 (the kernel's scalar instantiation), and the
             graph without self-loops, which has rows of degree 0, behind
             an allocator dirtied with NaN: both against the plain version.
4. small   — the port's Model trained 5 steps on the GPU and on the CPU
             (plain version) at rmat11 (ELL forced) and rmat13; the
             trajectories must agree.
5. main    — the GCN main path: Model(make_config("gcn", 2, 128, 128, 16,
             lr=0.01), ds, device="cuda").train(5) on rmat17, then
             evaluate("test"); counts the kernel's launches.
6. epochs  — the same model on after those 5 warm-up steps: the median of
             40 epochs with K1, and with K1's plain version swapped in,
             in the order kernel, plain, plain, kernel.
7. profile — 10 more epochs under torch.profiler: device time per epoch
             by kernel, and the device's busy share of the profiled wall
             time (the profiler slows the host, so that share is a floor).
8. result  — a JSON line of kernels, then the last line
             {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from graphaibench_tpu_torch import GnnDataset, rmat
from graphaibench_tpu_torch.nn import Model, make_config
from graphaibench_tpu_torch.nn.layers import apply_model
from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import ell_spmm as K1
from graphaibench_tpu_torch.ops.device_graph import pack_edge_values, to_device_graph

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
# The card's published peaks (H100 SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Small-model trajectories, GPU vs CPU: the same float32 reordering,
# compounded over 5 Adam steps.
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5
TIMED_CALLS = 20         # back-to-back calls between one pair of events
TIMED_BATCHES = 7
TIMED_EPOCHS = 40
PROFILED_EPOCHS = 10


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
    so = _build.build()
    _build.load_library()
    dt = time.perf_counter() - t0
    print(f"[build] {so.name} in {dt:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


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
            case = {"F": f, "view": view, "tile": K1._tile_floats(dg.nv, f),
                    "max_abs_err": err, "ms": ms,
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
    for scale, impl in ((11, "ell"), (13, "auto")):
        ds = _dataset(rmat(scale, 8, seed=1), 32, 4)
        cfg = make_config("gcn", 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
        runs = {}
        for dev in ("cuda", "cpu"):
            m = Model(cfg, ds, device=dev)
            log = m.train(EPOCHS, verbose=False)
            params = [p.detach().cpu().numpy() for p in m.params.parameters()]
            runs[dev] = (np.array([(l, a) for l, a, _ in log]), params)
        np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                                   rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
        for pc, pp in zip(runs["cuda"][1], runs["cpu"][1]):
            np.testing.assert_allclose(pc, pp, rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
        print(f"[small] rmat{scale} spmm_impl={impl}: GPU losses "
              f"{runs['cuda'][0][:, 0].tolist()} match the CPU run")


def phase_main(g) -> int:
    ds = _dataset(g, FEAT, CLASSES)
    t0 = time.perf_counter()
    model = Model(make_config("gcn", 2, FEAT, HIDDEN, CLASSES, lr=0.01), ds,
                  device="cuda")
    torch.cuda.synchronize()
    print(f"[main] Model set-up {time.perf_counter() - t0:.2f} s "
          f"(nv={model.full.device.nv} ne={model.full.device.ne})")
    torch.cuda.reset_peak_memory_stats()
    K1.LAUNCHES = 0
    log = model.train(EPOCHS)
    train_launches = K1.LAUNCHES
    acc = model.evaluate("test")
    launches = K1.LAUNCHES
    eval_launches = launches - train_launches
    losses = [l for l, _, _ in log]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease: {losses}")
    if train_launches != EPOCHS * SPMMS_PER_STEP:
        raise RuntimeError(f"{train_launches} kernel launches in training, "
                           f"expected {EPOCHS * SPMMS_PER_STEP}")
    if eval_launches != SPMMS_PER_EVAL:
        raise RuntimeError(f"{eval_launches} kernel launches in evaluate, "
                           f"expected {SPMMS_PER_EVAL}")
    if not 0.0 <= acc <= 1.0:
        raise RuntimeError(f"test accuracy {acc} outside [0, 1]")
    with torch.no_grad():
        logits = apply_model(model.cfg, model.params, model.full.device,
                             model.full.edge_w_agg, model.feats)
    if tuple(logits.shape) != (ds.graph.nv, CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"bad logits: shape {tuple(logits.shape)}")
    epoch_ms = statistics.median(dt for _, _, dt in log) * 1e3
    print(f"[main] losses {losses} test_acc {acc:.4f}")
    print(f"[main] launches: train {train_launches} eval {eval_launches}; "
          f"epoch median {epoch_ms:.3f} ms (warm-up epochs included); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, launches


def _epoch_median_ms(model, plain: bool) -> float:
    """Median epoch time over TIMED_EPOCHS; with ``plain``, K1's wrapper
    sends CUDA tensors to the plain version instead of the kernel."""
    cuda_route = K1._ell_spmm_cuda
    if plain:
        K1._ell_spmm_cuda = lambda table, x: K1.ell_spmm_plain(
            table.graph, table.w_slots, x)
    try:
        log = model.train(TIMED_EPOCHS, verbose=False)
    finally:
        K1._ell_spmm_cuda = cuda_route
    if not all(np.isfinite([l for l, _, _ in log])):
        raise RuntimeError("non-finite loss in the timed epochs")
    return statistics.median(dt for _, _, dt in log) * 1e3


def phase_epochs(model) -> float:
    runs = [(plain, _epoch_median_ms(model, plain))
            for plain in (False, True, True, False)]
    kernel = [ms for plain, ms in runs if not plain]
    plain = [ms for plain, ms in runs if plain]
    print(f"[epochs] median of {TIMED_EPOCHS} epochs, kernel/plain/plain/"
          f"kernel: {[round(ms, 4) for _, ms in runs]} ms; kernel "
          f"{statistics.mean(kernel):.4f} ms, plain "
          f"{statistics.mean(plain):.4f} ms")
    return statistics.mean(kernel)


def phase_profile(model, epoch_ms: float) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train(PROFILED_EPOCHS, verbose=False)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("[profile] the profiler recorded no device events: device "
              "time and busy share not measured")
        return
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
    device_ms = busy / PROFILED_EPOCHS / 1e3
    print(f"[profile] {PROFILED_EPOCHS} epochs: device busy "
          f"{device_ms:.4f} ms/epoch, {len(dev) / PROFILED_EPOCHS:.1f} "
          f"device ops/epoch, busy share {busy / wall_us:.4f} of the "
          f"profiled wall time; {device_ms / epoch_ms:.4f} of the unprofiled "
          f"{epoch_ms:.4f} ms epoch (device time and wall time from two runs)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        print(f"[profile] {us / PROFILED_EPOCHS / 1e3:.4f} ms/epoch "
              f"{us / busy:.4f} of device time, {n / PROFILED_EPOCHS:g}/epoch: "
              f"{name[:90]}")


def main() -> None:
    name = phase_device()
    phase_build()
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGE_FACTOR, seed=0)
    print(f"[graph] rmat({SCALE}, {EDGE_FACTOR}) generated in "
          f"{time.perf_counter() - t0:.2f} s")
    cases, other_err = phase_kernel(g)
    phase_small()
    model, launches = phase_main(g)
    phase_profile(model, phase_epochs(model))
    head = cases[0]
    print(json.dumps({"kernels": [{
        "name": "ell_spmm",
        "route": "cuda",
        "source": "graphaibench_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "graphaibench_tpu/ops/pallas_spmm.py:43",
        "launches": launches,
        "max_abs_err": max(other_err, *(c["max_abs_err"] for c in cases)),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": cases,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
