#!/usr/bin/env python3
"""Time the four GAT v2 kernels of the port (``csrc/fused_gat.cu``) on one
CUDA card under their tuning choices, and the three passes over per-edge
values that v1 runs on (``csrc/ell_edge.cu``), in one run:

    python3 tools/gat_kernels_probe.py [--scale 17] [--tiles-only]

On rmat(scale, 16) with self-loops, for F in {128, 16}, it builds the
source once per (slots gathered together, lanes per row of gat_rowmax)
variant and, for each build, times every kernel with the wrapper's own
feature-tile rule and with the tile forced to each width that divides
the work differently (floats per tile; "none" is one tile up to 128
floats); ``--tiles-only`` stops after the first build. Every variant is first held against the plain PyTorch version
(rtol 1e-4, atol 1e-4 of the largest |plain| value). A time is the
kernel's device time under torch.profiler, the mean of 20 back-to-back
calls; the inputs stay in L2 as the last call left them. After the first
build it times ``ell_row_reduce`` (max, sum, sumexp), and ``gat_v1_fwd``
(under the same tile widths) and ``sddmm_dot_ell`` for both F, with a
random 0/1 mask as edge weights, each first held against its plain
version; those rows carry ``"source": "ell_edge"``.

Prints the card's nvidia-smi name and power limit, one line per
measurement, and a last JSON line with every time in ms. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from graphaibench_tpu_torch import rmat  # noqa: E402
from graphaibench_tpu_torch.nn.model import prepare_graph  # noqa: E402
from graphaibench_tpu_torch.ops import _build  # noqa: E402
from graphaibench_tpu_torch.ops import ell_edge as EE  # noqa: E402
from graphaibench_tpu_torch.ops import fused_gat as FG  # noqa: E402
from graphaibench_tpu_torch.ops.device_graph import to_device_graph  # noqa: E402

CALLS = 20
VARIANTS = ((4, 3), (8, 3), (2, 3), (4, 2), (4, 4))   # (chunk, rowmax lg)
TILES = {128: (None, 128, 64, 32, 16), 16: (None, 16, 8)}


def _device_ms(fn, kernel: str) -> float:
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the mean over CALLS calls under torch.profiler (a host
    clock or an event pair would read the wrapper's host work where the
    kernel is short)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    if len(us) < CALLS // 2:      # the profiler may drop a few events
        raise RuntimeError(f"{len(us)} device events of {kernel}, expected "
                           f"{CALLS}")
    return statistics.mean(us) / 1e3


def _close(got, want, what):
    atol = 1e-4 * max(1.0, float(want.abs().max()))
    if not torch.allclose(got, want, rtol=1e-4, atol=atol):
        raise RuntimeError(f"{what}: kernel disagrees with plain, max |diff| "
                           f"{float((got - want).abs().max())}")


def _edge_rows(dg, gen) -> list[dict]:
    """Device times of the three kernels of csrc/ell_edge.cu (their source
    has no build-time variants; gat_v1_fwd takes the wrappers' tile)."""
    logits = 2.0 * torch.randn(dg.ne, device="cuda", generator=gen)
    mask = (torch.rand(dg.ne, device="cuda", generator=gen) < 0.7).float()
    m = EE.ell_row_reduce_plain(dg, logits, "max")
    if not torch.equal(EE.ell_row_reduce(dg, logits, "max"), m):
        raise RuntimeError("ell_row_reduce max differs from plain")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = EE.ell_row_reduce_plain(dg, logits, "sumexp", m)
    _close(EE.ell_row_reduce(dg, logits, "sum"),
           EE.ell_row_reduce_plain(dg, logits, "sum"), "row sum")
    _close(EE.ell_row_reduce(dg, logits, "sumexp", m), z, "row sumexp")
    zinv = 1.0 / torch.clamp(z, min=FG.Z_FLOOR)
    rows = [{"source": "ell_edge", "ell_row_reduce": {
        kind: _device_ms(lambda: EE.ell_row_reduce(dg, logits, kind, *shift),
                         "ell_row_reduce_kernel")
        for kind, shift in (("max", ()), ("sum", ()), ("sumexp", (m,)))}}]
    rule = EE._wide_shape
    for f, tiles in TILES.items():
        x = torch.randn(dg.nv, f, device="cuda", generator=gen)
        ct = torch.randn(dg.nv, f, device="cuda", generator=gen)
        out = EE.gat_v1_fwd_plain(dg, logits, mask, x, m, zinv)
        _close(EE.sddmm_dot_ell(dg, ct, x), EE.sddmm_dot_ell_plain(dg, ct, x),
               "sddmm_dot_ell")
        row = {"source": "ell_edge", "F": f, "sddmm_dot_ell": _device_ms(
            lambda: EE.sddmm_dot_ell(dg, ct, x), "sddmm_dot_ell_kernel")}
        for tile in tiles:
            if tile is not None:
                EE._wide_shape = (lambda nv, f_, *mats, t=tile:
                                  (min(t, f_) // 4, 1,
                                   -(-(f_ // 4) // (min(t, f_) // 4))))
            try:
                _close(EE.gat_v1_fwd(dg, logits, mask, x, m, zinv), out,
                       "gat_v1_fwd")
                key = "rule" if tile is None else str(tile)
                row[f"gat_v1_fwd tile_{key}"] = _device_ms(
                    lambda: EE.gat_v1_fwd(dg, logits, mask, x, m, zinv),
                    "gat_v1_fwd_kernel")
            finally:
                EE._wide_shape = rule
        rows.append(row)
    for row in rows:
        print(json.dumps(row))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--tiles-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dg = to_device_graph(prepare_graph(rmat(args.scale, 16, seed=0), "gat"),
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    flags = _build.NVCC_FLAGS
    rule = FG._wide_shape
    results = []
    for chunk, lg in VARIANTS[:1] if args.tiles_only else VARIANTS:
        _build.NVCC_FLAGS = flags + (f"-DGAB_GAT_CHUNK={chunk}",
                                     f"-DGAB_GAT_ROWMAX_LG={lg}")
        _build._LIBS.pop("fused_gat", None)
        for f, tiles in TILES.items():
            sl = torch.randn(dg.nv, device="cuda", generator=gen)
            sr = torch.randn(dg.nv, device="cuda", generator=gen)
            h = torch.randn(dg.nv, f, device="cuda", generator=gen)
            ct = torch.randn(dg.nv, f, device="cuda", generator=gen)
            m0 = FG.gat_rowmax_plain(dg, sr)
            m = FG._leaky(sl + torch.where(torch.isfinite(m0), m0,
                                           torch.zeros_like(m0)))
            acc, z = FG.gat_v2_fwd_plain(dg, sl, sr, m, h)
            zinv = 1.0 / torch.clamp(z, min=FG.Z_FLOOR)
            inner = (ct * acc * zinv[:, None]).sum(1)
            bwd = (sl, sr, m, zinv, inner, h, ct)
            d_sl = FG.gat_v2_bwd_sl_plain(dg, *bwd)
            d_h, d_sr = FG.gat_v2_bwd_h_plain(dg, *bwd)
            if not torch.equal(FG.gat_rowmax(dg, sr), m0):
                raise RuntimeError("gat_rowmax differs from plain")
            row = {"chunk": chunk, "rowmax_lg": lg, "F": f,
                   "gat_rowmax": _device_ms(lambda: FG.gat_rowmax(dg, sr),
                                            "gat_rowmax_kernel")}
            # the tile is the wrapper's business: only the first variant
            # of the build constants walks through the forced widths
            for tile in tiles if (chunk, lg) == VARIANTS[0] else (None,):
                if tile is None:
                    FG._wide_shape = rule
                else:
                    FG._wide_shape = (lambda nv, f_, *mats, t=tile:
                                      (min(t, f_) // 4, 1,
                                       -(-(f_ // 4) // (min(t, f_) // 4))))
                a, zz = FG.gat_v2_fwd(dg, sl, sr, m, h)
                _close(a, acc, "acc")
                _close(zz, z, "z")
                _close(FG.gat_v2_bwd_sl(dg, *bwd), d_sl, "d_sl")
                dh, dsr = FG.gat_v2_bwd_h(dg, *bwd)
                _close(dh, d_h, "d_h")
                _close(dsr, d_sr, "d_sr")
                key = "rule" if tile is None else str(tile)
                row[f"tile_{key}"] = {
                    "gat_v2_fwd": _device_ms(
                        lambda: FG.gat_v2_fwd(dg, sl, sr, m, h),
                        "gat_v2_fwd_kernel"),
                    "gat_v2_bwd_sl": _device_ms(
                        lambda: FG.gat_v2_bwd_sl(dg, *bwd),
                        "gat_v2_bwd_sl_kernel"),
                    "gat_v2_bwd_h": _device_ms(
                        lambda: FG.gat_v2_bwd_h(dg, *bwd),
                        "gat_v2_bwd_h_kernel"),
                }
            FG._wide_shape = rule
            print(json.dumps(row))
            results.append(row)
        if (chunk, lg) == VARIANTS[0]:
            results += _edge_rows(dg, gen)
    print(json.dumps({"scale": args.scale, "nv": dg.nv, "ne": dg.ne,
                      "results": results}))


if __name__ == "__main__":
    main()
