#!/usr/bin/env python3
"""Time the GAT v2 kernels of the port (``csrc/fused_gat.cu``) on one CUDA
card under their tuning choices, and the three passes over per-edge
values that v1 runs on (``csrc/ell_edge.cu``), in one run:

    python3 tools/gat_kernels_probe.py [--scale 17] [--tiles-only]
    python3 tools/gat_kernels_probe.py --v2-only         # csrc/fused_gat.cu alone
    python3 tools/gat_kernels_probe.py --edge-only       # csrc/ell_edge.cu alone
    python3 tools/gat_kernels_probe.py --fwd-only        # gat_rowmax, gat_v2_fwd
    python3 tools/gat_kernels_probe.py --parent build/parent [--scale 19]
        [--parent-define GAB_GAT_ROWMAX_LG=2 ...]
    python3 tools/gat_kernels_probe.py --v1-step | --v2-step

On rmat(scale, 16) with self-loops, for F in {128, 16}, it builds
``csrc/fused_gat.cu`` once per variant of its build-time choices
(``VARIANTS``: lanes per row, columns per lane, slots gathered together,
blocks per SM, of the forward and of the backward; lanes per row of the
row max) and, for each build, times every kernel with
the wrapper's own feature-tile rule, and ``gat_v2_fwd`` also with the
tile forced to each width that divides the work differently (floats per
tile); the first build times the backward's kernels under those widths
too, and ``--tiles-only`` stops after it. ``--fwd-only`` builds only the
variants of the forward's and the row max's choices and times those two
kernels alone. The backward is timed as its two passes
(``gat_v2_bwd_sl``, ``gat_v2_bwd_h``) and as the single pass
(``gat_v2_bwd``): per kernel its own device time and, under "... call",
that of everything its wrapper launches. After the variants the backward's
kernels as shipped are timed at the widths in ``BETWEEN``, which is where
the wrapper's rule for the single pass was read from. Every variant is
first held against the plain PyTorch version (rtol 1e-4, atol 1e-4 of the
largest |plain| value). A time is the kernel's device time under
torch.profiler, the mean of 20 back-to-back calls; the inputs stay in L2
as the last call left them. Unless ``--v2-only``, it then times
``ell_row_reduce`` (max, sum, sumexp), and ``gat_v1_fwd`` (under the tile
widths, with and without the scores it can write) and ``sddmm_dot_ell``
for both F, with a random 0/1 mask as edge weights, each first held
against its plain version; those rows carry ``"source": "ell_edge"``.
Unless ``--tiles-only``, ``csrc/ell_edge.cu`` is then rebuilt under each
of its own build-time choices (``EDGE_VARIANTS``: slots gathered together,
lanes per row and columns per lane of ``sddmm_dot_ell``) and the two wide
passes are timed again; ``--edge-only`` skips the v2 kernels.

``--parent DIR`` compares two checkouts instead, in the order parent,
change, change, parent (the change is the checkout this script lies in;
make the parent's with
``git archive <commit> graphaibench_tpu_torch | tar -x -C build/parent``).
Each turn is a process of its own that imports ``graphaibench_tpu_torch``
from its tree, builds that tree's kernels, holds ``sddmm_dot_ell``,
``gat_v1_fwd`` and the v2 kernels (``gat_rowmax``, ``gat_v2_fwd`` and the
backward's) against their plain versions and times them at F = 128 and 16
on the same graph. ``--parent-define NAME=VALUE`` builds the parent's
kernels under that ``-D`` choice as well (repeatable).

``--v1-step`` times the GAT v1 training step of ``chip_smoke.py``
(2 layers, 128/128/16, a 0/1 mask as edge weights) as shipped, where the
forward pass writes the scores for the backward, and with a backward that
computes them again from the logits, in the order shipped, again, again,
shipped: device ms per step under the profiler and peak memory.
``--v2-step`` does the same for the v2 step (all-ones weights) with the
backward as two passes at every width and as shipped, in the order two
passes, shipped, shipped, two passes.

Prints the card's nvidia-smi name and power limit, one line per
measurement, and a last JSON line with every time in ms. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 20
# csrc/fused_gat.cu: build-time choices that differ from the source's own
# (the first variant), as -D flags. GAB_BWD_*: the two backward passes -
# log2 slots gathered together in groups of more than four lanes
# (CHUNK_LG) and of up to four (NARROW_CHUNK_LG), log2 of the most lanes a
# row gets in gat_v2_bwd_h (LANES_LG) and gat_v2_bwd_sl (SL_LANES_LG; a tile
# of 32 columns gives a lane 32 / lanes of them), the blocks per SM that
# bound gat_v2_bwd_h's registers (MIN_BLOCKS). GAB_FWD_*: log2 slots wide
# groups of gat_v2_fwd gather together, and its blocks per SM.
# GAB_GAT_ROWMAX_LG: log2 lanes per row of gat_rowmax.
VARIANTS = (
    {}, {"GAB_FWD_MIN_BLOCKS": 4}, {"GAB_FWD_MIN_BLOCKS": 5},
    {"GAB_FWD_MIN_BLOCKS": 7}, {"GAB_FWD_CHUNK_LG": 2},
    {"GAB_GAT_ROWMAX_LG": 3}, {"GAB_GAT_ROWMAX_LG": 4},
    {"GAB_BWD_LANES_LG": 5}, {"GAB_BWD_LANES_LG": 3},
    {"GAB_BWD_SL_LANES_LG": 4}, {"GAB_BWD_SL_LANES_LG": 3},
    {"GAB_BWD_CHUNK_LG": 2}, {"GAB_BWD_CHUNK_LG": 4},
    {"GAB_BWD_NARROW_CHUNK_LG": 3}, {"GAB_BWD_NARROW_CHUNK_LG": 4},
    {"GAB_BWD_MIN_BLOCKS": 1}, {"GAB_BWD_MIN_BLOCKS": 2},
    {"GAB_BWD_MIN_BLOCKS": 4},
)
BETWEEN = (64, 32, 8)   # widths between and below the main path's
TILES = {128: (None, 128, 64, 32, 16), 16: (None, 16, 8)}
# csrc/ell_edge.cu: (log2 slots gathered together by gat_v1_fwd in groups of
# more than four lanes, and of up to four; the same of sddmm_dot_ell, its
# columns per lane in registers, log2 of its most lanes per row); the first
# is the source's own choice
EDGE_VARIANTS = ((3, 4, 3, 2, 4), (3, 3, 2, 2, 4), (3, 5, 3, 4, 3),
                 (2, 4, 2, 4, 3), (4, 4, 3, 1, 5), (3, 4, 4, 2, 4))
EDGE_FLAGS = ("GAB_V1_CHUNK_LG", "GAB_V1_NARROW_CHUNK_LG", "GAB_DOT_CHUNK_LG",
              "GAB_DOT_COLS", "GAB_DOT_LANES_LG")


def _import_port(tree: str) -> None:
    """The port's modules, from the checkout at ``tree``."""
    global CSRGraph, rmat, prepare_graph, _build, EE, FG, to_device_graph
    sys.path.insert(0, os.path.abspath(tree))
    from graphaibench_tpu_torch import CSRGraph, rmat
    from graphaibench_tpu_torch.nn.model import prepare_graph
    from graphaibench_tpu_torch.ops import _build
    from graphaibench_tpu_torch.ops import ell_edge as EE
    from graphaibench_tpu_torch.ops import fused_gat as FG
    from graphaibench_tpu_torch.ops.device_graph import to_device_graph


def _device_ms(fn, kernel: str = "") -> float:
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the mean over CALLS calls under torch.profiler (a host
    clock or an event pair would read the wrapper's host work where the
    kernel is short). Without a name, the device time of everything one
    call of ``fn`` launches, the copies and fills included."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    us = []
    for _ in range(3):            # now and then a trace comes back empty
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if len(us) >= CALLS // 2:  # the profiler may drop a few events
            return (statistics.mean(us) if kernel else sum(us) / CALLS) / 1e3
    raise RuntimeError(f"{len(us)} device events of {kernel}, expected {CALLS}")


def _close(got, want, what):
    atol = 1e-4 * max(1.0, float(want.abs().max()))
    if not torch.allclose(got, want, rtol=1e-4, atol=atol):
        raise RuntimeError(f"{what}: kernel disagrees with plain, max |diff| "
                           f"{float((got - want).abs().max())}")


def _ptxas(name: str) -> dict[str, str]:
    """Registers and spill bytes per kernel of ``csrc/<name>.cu``, from the
    compiler report kept beside the library."""
    log = _build._library_path(f"{name}.cu").with_suffix(".log").read_text()
    out, entry, spill = {}, None, ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\w*?\d((?:[a-z]+\d?_)+kernel)"
                          r"I(6float4|f)?((?:Li\d+E)+)", line)
        if found:
            of = {"6float4": "float4, ", "f": "float, ", None: ""}
            ints = ", ".join(re.findall(r"Li(\d+)E", found.group(3)))
            entry = f"{found.group(1)}<{of[found.group(2)]}{ints}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            stores = re.search(r"(\d+) bytes spill stores", spill)
            out[entry] = (f"{regs} regs, "
                          f"{stores.group(1) if stores else '?'} B spilt")
            entry = None
    return out


def _edge_inputs(dg, gen):
    """Per-edge logits, a 0/1 mask, and the logits' row max and inverse
    softmax denominator by the plain passes."""
    logits = 2.0 * torch.randn(dg.ne, device="cuda", generator=gen)
    mask = (torch.rand(dg.ne, device="cuda", generator=gen) < 0.7).float()
    m = EE.ell_row_reduce_plain(dg, logits, "max")
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = EE.ell_row_reduce_plain(dg, logits, "sumexp", m)
    return logits, mask, m, z


def _reduce_row(dg, logits, m, z) -> dict:
    """Device times of ell_row_reduce in its three kinds."""
    if not torch.equal(EE.ell_row_reduce(dg, logits, "max"),
                       EE.ell_row_reduce_plain(dg, logits, "max")):
        raise RuntimeError("ell_row_reduce max differs from plain")
    _close(EE.ell_row_reduce(dg, logits, "sum"),
           EE.ell_row_reduce_plain(dg, logits, "sum"), "row sum")
    _close(EE.ell_row_reduce(dg, logits, "sumexp", m), z, "row sumexp")
    return {"source": "ell_edge", "ell_row_reduce": {
        kind: _device_ms(lambda: EE.ell_row_reduce(dg, logits, kind, *shift),
                         "ell_row_reduce_kernel")
        for kind, shift in (("max", ()), ("sum", ()), ("sumexp", (m,)))}}


def _wide_rows(dg, gen, logits, mask, m, z, tiles: bool,
               **tag) -> list[dict]:
    """Device times of sddmm_dot_ell and gat_v1_fwd for both F, each first
    held against its plain version; gat_v1_fwd under the wrapper's tile
    and, with ``tiles``, under each forced one, and where the checkout's
    pass can write the scores, with them as well. Each row is printed as
    it is made, with ``tag`` added."""
    zinv = 1.0 / torch.clamp(z, min=FG.Z_FLOOR)
    scores = "with_scores" in inspect.signature(EE.gat_v1_fwd).parameters
    rule = EE._wide_shape
    rows = []
    for f, widths in TILES.items():
        x = torch.randn(dg.nv, f, device="cuda", generator=gen)
        ct = torch.randn(dg.nv, f, device="cuda", generator=gen)
        out = EE.gat_v1_fwd_plain(dg, logits, mask, x, m, zinv)
        _close(EE.sddmm_dot_ell(dg, ct, x), EE.sddmm_dot_ell_plain(dg, ct, x),
               "sddmm_dot_ell")
        row = {"source": "ell_edge", "F": f, "sddmm_dot_ell": _device_ms(
            lambda: EE.sddmm_dot_ell(dg, ct, x), "sddmm_dot_ell_kernel")}
        for tile in widths if tiles else (None,):
            if tile is not None:
                EE._wide_shape = (lambda nv, f_, *mats, t=tile, **rule:
                                  (min(t, f_) // 4, 1,
                                   -(-(f_ // 4) // (min(t, f_) // 4))))
            try:
                _close(EE.gat_v1_fwd(dg, logits, mask, x, m, zinv), out,
                       "gat_v1_fwd")
                key = "rule" if tile is None else str(tile)
                row[f"gat_v1_fwd tile_{key}"] = _device_ms(
                    lambda: EE.gat_v1_fwd(dg, logits, mask, x, m, zinv),
                    "gat_v1_fwd_kernel")
                if scores:
                    got, sc = EE.gat_v1_fwd(dg, logits, mask, x, m, zinv, True)
                    _close(got, out, "gat_v1_fwd with scores")
                    _close(sc, torch.exp(logits - m[dg.edge_src.long()])
                           * zinv[dg.edge_src.long()], "scores")
                    row[f"gat_v1_fwd tile_{key} scores"] = _device_ms(
                        lambda: EE.gat_v1_fwd(dg, logits, mask, x, m, zinv,
                                              True), "gat_v1_fwd_kernel")
            finally:
                EE._wide_shape = rule
        print(json.dumps(dict(row, **tag)))
        rows.append(dict(row, **tag))
    return rows


def _edge_rows(dg, gen, variants: bool) -> list[dict]:
    """The three kernels of csrc/ell_edge.cu as built, then the two wide
    passes under each of EDGE_VARIANTS."""
    logits, mask, m, z = _edge_inputs(dg, gen)
    rows = [_reduce_row(dg, logits, m, z)]
    print(json.dumps(rows[0]))
    rows += _wide_rows(dg, gen, logits, mask, m, z, tiles=True)
    flags = _build.NVCC_FLAGS
    for variant in EDGE_VARIANTS[1:] if variants else ():
        _build.NVCC_FLAGS = flags + tuple(
            f"-D{name}={v}" for name, v in zip(EDGE_FLAGS, variant))
        _build._LIBS.pop("ell_edge", None)
        try:
            tag = dict(zip(EDGE_FLAGS, variant))
            rows += _wide_rows(dg, gen, logits, mask, m, z, tiles=False,
                               variant=tag)
            rows.append({"source": "ell_edge", "variant": tag,
                         "ptxas": _ptxas("ell_edge")})
            print(json.dumps(rows[-1]))
        finally:
            _build.NVCC_FLAGS = flags
            _build._LIBS.pop("ell_edge", None)
    return rows


def _v2_inputs(dg, f: int, gen):
    """The v2 passes' operands at width ``f`` and the plain versions'
    results: (sl, sr, m, h), the backward's arguments, and a dict of the
    expected outputs."""
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
    d_h, d_sr = FG.gat_v2_bwd_h_plain(dg, *bwd)
    want = {"m0": m0, "acc": acc, "z": z, "d_h": d_h, "d_sr": d_sr,
            "d_sl": FG.gat_v2_bwd_sl_plain(dg, *bwd)}
    return (sl, sr, m, h), bwd, want


def _bwd_row(dg, bwd, want) -> dict:
    """Device times of the backward's kernels, each first held against the
    plain versions: the two passes and, where the checkout has it, the
    single pass. Per kernel its own time and, under "... call", that of
    everything its wrapper launches (the fills of its outputs, the
    packing of the per-vertex scalars)."""
    _close(FG.gat_v2_bwd_sl(dg, *bwd), want["d_sl"], "d_sl")
    dh, dsr = FG.gat_v2_bwd_h(dg, *bwd)
    _close(dh, want["d_h"], "d_h")
    _close(dsr, want["d_sr"], "d_sr")
    passes = {"gat_v2_bwd_sl": "gat_v2_bwd_sl_kernel",
              "gat_v2_bwd_h": "gat_v2_bwd_h_kernel"}
    if hasattr(FG, "gat_v2_bwd"):
        dsl, dsr, dh = FG.gat_v2_bwd(dg, *bwd)
        _close(dsl, want["d_sl"], "single pass d_sl")
        _close(dh, want["d_h"], "single pass d_h")
        _close(dsr, want["d_sr"], "single pass d_sr")
        passes["gat_v2_bwd"] = "gat_v2_bwd_h_kernel"
    row = {}
    for name, kernel in passes.items():
        fn = getattr(FG, name)
        row[name] = _device_ms(lambda: fn(dg, *bwd), kernel)
        row[f"{name} call"] = _device_ms(lambda: fn(dg, *bwd))
    return row


def _v2_rows(dg, gen, tiles_only: bool, fwd_only: bool) -> list[dict]:
    """The kernels of csrc/fused_gat.cu under each of VARIANTS (the first
    alone with ``tiles_only``; with ``fwd_only`` those that set only the
    forward's and the row max's choices, and no backward): gat_v2_fwd
    under each forced tile in every build, the backward's kernels under
    them in the first build and under the wrapper's rule in the others."""
    flags = _build.NVCC_FLAGS
    rule = FG._wide_shape
    variants = [v for v in VARIANTS if not fwd_only or all(
        k.startswith(("GAB_FWD", "GAB_GAT")) for k in v)]
    results = []
    for n, variant in enumerate(variants[:1] if tiles_only else variants):
        _build.NVCC_FLAGS = flags + tuple(
            f"-D{name}={v}" for name, v in variant.items())
        _build._LIBS.pop("fused_gat", None)
        for f, tiles in TILES.items():
            (sl, sr, m, h), bwd, want = _v2_inputs(dg, f, gen)
            if not torch.equal(FG.gat_rowmax(dg, sr), want["m0"]):
                raise RuntimeError("gat_rowmax differs from plain")
            row = {"variant": variant, "F": f,
                   "gat_rowmax": _device_ms(lambda: FG.gat_rowmax(dg, sr),
                                            "gat_rowmax_kernel")}
            for tile in tiles:
                if tile is None:
                    FG._wide_shape = rule
                else:
                    FG._wide_shape = (lambda nv, f_, *mats, t=tile, **rule:
                                      (min(t, f_) // 4, 1,
                                       -(-(f_ // 4) // (min(t, f_) // 4))))
                a, zz = FG.gat_v2_fwd(dg, sl, sr, m, h)
                _close(a, want["acc"], "acc")
                _close(zz, want["z"], "z")
                key = "rule" if tile is None else str(tile)
                cell = {"gat_v2_fwd": _device_ms(
                    lambda: FG.gat_v2_fwd(dg, sl, sr, m, h),
                    "gat_v2_fwd_kernel")}
                if not fwd_only and (n == 0 or tile is None):
                    cell.update(_bwd_row(dg, bwd, want))
                row[f"tile_{key}"] = cell
            FG._wide_shape = rule
            print(json.dumps(row))
            results.append(row)
        results.append({"variant": variant, "ptxas": _ptxas("fused_gat")})
        print(json.dumps(results[-1]))
    _build.NVCC_FLAGS = flags
    _build._LIBS.pop("fused_gat", None)
    return results


def _v2_fwd_rows(dg, gen) -> list[dict]:
    """The forward's kernels as built, at F = 128 and 16: gat_rowmax
    held bit for bit, gat_v2_fwd within the tolerance, then timed."""
    rows = []
    for f in TILES:
        (sl, sr, m, h), _, want = _v2_inputs(dg, f, gen)
        if not torch.equal(FG.gat_rowmax(dg, sr), want["m0"]):
            raise RuntimeError("gat_rowmax differs from plain")
        a, zz = FG.gat_v2_fwd(dg, sl, sr, m, h)
        _close(a, want["acc"], "acc")
        _close(zz, want["z"], "z")
        rows.append({"source": "fused_gat", "F": f,
                     "gat_rowmax": _device_ms(lambda: FG.gat_rowmax(dg, sr),
                                              "gat_rowmax_kernel"),
                     "gat_v2_fwd": _device_ms(
                         lambda: FG.gat_v2_fwd(dg, sl, sr, m, h),
                         "gat_v2_fwd_kernel")})
        print(json.dumps(rows[-1]))
    return rows


def _v2_bwd_rows(dg, gen, widths=tuple(TILES)) -> list[dict]:
    """The backward's kernels as built, at F = 128 and 16."""
    rows = []
    for f in widths:
        _, bwd, want = _v2_inputs(dg, f, gen)
        rows.append({"source": "fused_gat", "F": f, **_bwd_row(dg, bwd, want)})
        print(json.dumps(rows[-1]))
    return rows


def worker(tree: str, graph_npz: str, defines=()) -> None:
    """One turn of ``--parent``: the two wide passes of csrc/ell_edge.cu
    and the v2 kernels of the checkout at ``tree`` on the graph in
    ``graph_npz``, built under the ``-D`` choices ``defines``."""
    _import_port(tree)
    _build.NVCC_FLAGS += tuple(f"-D{d}" for d in defines)
    z = np.load(graph_npz)
    dg = to_device_graph(prepare_graph(
        CSRGraph(row_ptr=z["row_ptr"], col_idx=z["col_idx"]), "gat"),
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    logits, mask, m, zz = _edge_inputs(dg, gen)
    rows = _wide_rows(dg, gen, logits, mask, m, zz, tiles=False)
    rows += _v2_fwd_rows(dg, gen)
    rows += _v2_bwd_rows(dg, gen)
    print("GAT_PROBE " + json.dumps({
        "tree": tree, "defines": list(defines), "rows": rows,
        "ptxas": _ptxas("ell_edge"),
        "ptxas_v2": _ptxas("fused_gat")}))


def compare(parent: str, scale: int, defines=()) -> list[dict]:
    """parent, change, change, parent: one process each; the parent's
    built under the ``-D`` choices ``defines``."""
    _import_port(ROOT)
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "graph.npz")
        g = rmat(scale, 16, seed=0, cache=False)
        np.savez(npz, row_ptr=g.row_ptr, col_idx=g.col_idx)
        order = [("parent", parent), ("change", ROOT), ("change", ROOT),
                 ("parent", parent)]
        for name, tree in order:
            extra = [f"--parent-define={d}" for d in defines
                     ] if name == "parent" else []
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 npz, *extra], capture_output=True, text=True, timeout=900)
            lines = [l for l in r.stdout.splitlines()
                     if l.startswith("GAT_PROBE ")]
            if r.returncode != 0 or not lines:
                print(r.stdout[-4000:], r.stderr[-8000:], sep="\n",
                      file=sys.stderr)
                raise SystemExit(f"the {name} turn failed with code "
                                 f"{r.returncode}")
            res = json.loads(lines[-1][len("GAT_PROBE "):])
            res["turn"] = name
            turns.append(res)
            for row in res["rows"]:
                print(f"{name}: " + json.dumps(row))
            sys.stdout.flush()
    return turns


def v1_step(scale: int) -> list[dict]:
    """The v1 step of chip_smoke.py with the scores written by the forward
    pass (as shipped) and computed again by the backward."""
    _import_port(ROOT)
    import chip_smoke

    class _Recompute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, g, logits, edge_w, x, differentiated):
            logits, edge_w, x = (logits.contiguous(), edge_w.contiguous(),
                                 x.contiguous())
            m, zinv = FG._norm_consts(g, logits)
            ctx.g = g
            ctx.save_for_backward(logits, edge_w, x, m, zinv)
            return EE.gat_v1_fwd(g, logits, edge_w, x, m, zinv)

        @staticmethod
        def backward(ctx, ct):
            logits, edge_w, x, m, zinv = ctx.saved_tensors
            src = ctx.g.edge_src
            s_soft = torch.exp(logits - m[src]) * zinv[src]
            return (None, *FG._v1_backward(ctx.g, ct.contiguous(), edge_w, x,
                                           s_soft, ctx.needs_input_grad[1:4]),
                    None)

    g = rmat(scale, 16, seed=0)
    shipped = FG._GatV1
    turns = []
    try:
        for name, op in (("shipped", shipped), ("recompute", _Recompute),
                         ("recompute", _Recompute), ("shipped", shipped)):
            FG._GatV1 = op
            _, stats = chip_smoke.phase_main_v1(g)
            turns.append(dict(stats, turn=name))
            print(f"{name}: " + json.dumps(stats))
    finally:
        FG._GatV1 = shipped
    return turns


def v2_step(scale: int) -> list[dict]:
    """The GAT training step of chip_smoke.py (2 layers, 128/128/16, v2)
    with the backward as two passes (gat_v2_bwd_sl, gat_v2_bwd_h) and as
    shipped, in the order two passes, shipped, shipped, two passes: the
    host-clock median of 20 steps, then device ms and ops per step over
    10 profiled steps, and the peak memory."""
    _import_port(ROOT)
    import chip_smoke
    from graphaibench_tpu_torch.nn import Model, make_config

    shipped = FG._GatV2

    class _TwoPass(shipped):
        @staticmethod
        def backward(ctx, ct):
            sl, sr, h, m, zinv, out = ctx.saved_tensors
            ct = ct.contiguous()
            args = (sl, sr, m, zinv, (ct * out).sum(1), h, ct)
            d_h, d_sr = FG.gat_v2_bwd_h(ctx.gt, *args)
            return None, None, FG.gat_v2_bwd_sl(ctx.g, *args), d_sr, d_h

    cfg = make_config("gat", chip_smoke.GAT_LAYERS, chip_smoke.FEAT,
                      chip_smoke.HIDDEN, chip_smoke.CLASSES, lr=0.01,
                      use_l2norm=False, use_dense=False)
    model = Model(cfg, chip_smoke._dataset(rmat(scale, 16, seed=0),
                                           chip_smoke.FEAT, chip_smoke.CLASSES),
                  device="cuda")
    model.train(chip_smoke.EPOCHS, verbose=False)
    turns = []
    try:
        for name, op in (("two passes", _TwoPass), ("shipped", shipped),
                         ("shipped", shipped), ("two passes", _TwoPass)):
            FG._GatV2 = op
            torch.cuda.reset_peak_memory_stats()
            log = model.train(chip_smoke.TIMED_EPOCHS, verbose=False)
            step_ms = statistics.median(dt for _, _, dt in log) * 1e3
            device_ms, ops = chip_smoke.phase_profile(
                f"gat v2, {name}", lambda n: model.train(n, verbose=False),
                chip_smoke.PROFILED_EPOCHS, step_ms)
            turns.append({"turn": name, "step_ms": step_ms,
                          "device_ms": device_ms, "device_ops": ops,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
            print(f"{name}: " + json.dumps(turns[-1]))
    finally:
        FG._GatV2 = shipped
    return turns


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--tiles-only", action="store_true")
    ap.add_argument("--edge-only", action="store_true",
                    help="skip the v2 kernels of csrc/fused_gat.cu")
    ap.add_argument("--v2-only", action="store_true",
                    help="skip the passes of csrc/ell_edge.cu")
    ap.add_argument("--fwd-only", action="store_true",
                    help="gat_rowmax and gat_v2_fwd alone, under their "
                    "own build-time choices")
    ap.add_argument("--parent", help="root of the parent commit's checkout: "
                    "compare its wide passes of csrc/ell_edge.cu and its v2 "
                    "kernels with this checkout's")
    ap.add_argument("--parent-define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="build the parent's kernels under this -D choice")
    ap.add_argument("--v1-step", action="store_true")
    ap.add_argument("--v2-step", action="store_true")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "GRAPH_NPZ"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.worker:
        worker(*args.worker, args.parent_define)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    if args.parent:
        print(json.dumps({"card": card, "scale": args.scale,
                          "turns": compare(args.parent, args.scale,
                                           args.parent_define)}))
        return
    if args.v1_step or args.v2_step:
        step = v1_step if args.v1_step else v2_step
        print(json.dumps({"card": card, "scale": args.scale,
                          "turns": step(args.scale)}))
        return
    _import_port(ROOT)
    dg = to_device_graph(prepare_graph(rmat(args.scale, 16, seed=0), "gat"),
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = ([] if args.edge_only
               else _v2_rows(dg, gen, args.tiles_only, args.fwd_only))
    if not (args.edge_only or args.fwd_only):
        # where the single pass starts to pay: the widths between the two
        results += _v2_bwd_rows(dg, gen, BETWEEN)
    if not (args.v2_only or args.fwd_only):
        results += _edge_rows(dg, gen, variants=not args.tiles_only)
    print(json.dumps({"card": card, "scale": args.scale, "nv": dg.nv,
                      "ne": dg.ne, "results": results}))


if __name__ == "__main__":
    main()
