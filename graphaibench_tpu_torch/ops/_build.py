"""Build and load the port's CUDA kernels.

Each source in ``graphaibench_tpu_torch/csrc`` is compiled with ``nvcc``
for sm_90a into a shared library of its own with a plain C interface, at
first use, into ``build/torch_kernels/`` of the checkout, keyed by a hash
of the source, the headers beside it (``*.cuh``) and the flags. The sources that still need building are
compiled side by side, one ``nvcc`` each. A library is loaded with
``ctypes``; pointers and the stream travel as ``c_void_p``, sizes as
``c_int64``, and a kernel's per-bucket arrays as ctypes arrays of those.

There is no fallback here: without a CUDA device or without ``nvcc``,
``load_library`` raises. Only the wrappers decide to take a kernel's plain
version, and only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ell_spmm.cu", "fused_gat.cu", "ell_edge.cu", "ell_pull.cu",
           "tc_count.cu", "kcore_hindex.cu", "cgr_decode.cu",
           "vbyte_decode.cu", "coloring.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# No --use_fast_math: it flushes subnormals to zero and swaps expf for
# __expf; the GAT passes rely on a normal 1e-30 floor and on expf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_vpp = ctypes.POINTER(_vp)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_int, _i64 = ctypes.c_int, ctypes.c_int64
# per-bucket arrays of the bucket passes (GAB_TABLE_PARAMS of
# csrc/ell_table.cuh): row_ids, nbr, edge_id, valid, rows, widths, n
_GAT_TABLE = [_vpp, _vpp, _vpp, _vpp, _i64p, _i32p, _int]
_WIDE = [_i64, _int, _int, _int, _vp]   # f, tile_v, vec, device, stream
# C entry points per library: name -> argtypes (every one returns int)
_SIGNATURES = {
    "ell_spmm": {
        "gab_ell_spmm": [_vpp, _vpp, _vpp, _i64p, _i32p, _int, _vp, _vp, _vp,
                         _i64, _int, _int, _vp],
    },
    "fused_gat": {
        "gab_gat_rowmax": _GAT_TABLE + [_vp] * 3 + [_int, _vp],
        "gab_gat_v2_fwd": _GAT_TABLE + [_vp] * 7 + _WIDE,
        "gab_gat_v2_bwd_sl": _GAT_TABLE + [_vp] * 9 + _WIDE,
        "gab_gat_v2_bwd_h": _GAT_TABLE + [_vp] * 8 + _WIDE,
    },
    "ell_edge": {
        "gab_ell_row_reduce": _GAT_TABLE + [_vp] * 4 + [_int, _int, _vp],
        "gab_gat_v1_fwd": _GAT_TABLE + [_vp] * 8 + _WIDE,
        "gab_sddmm_dot_ell": _GAT_TABLE + [_vp] * 3 + [_i64, _int, _int, _vp],
    },
    "ell_pull": {
        # is_split, edge_vals (per-bucket pointers or null), vals, out, kind,
        # dtype, device, stream
        "gab_neighbor_reduce": _GAT_TABLE + [_vp, _vpp, _vp, _vp, _int, _int,
                                             _int, _vp],
    },
    "tc_count": {
        # row_ptr, col_idx, src, dst, tasks, class_start (host), total,
        # device, stream
        "gab_tc_count": [_vp] * 5 + [_i64p, _vp, _int, _vp],
    },
    "kcore_hindex": {
        # row_ptr, col_idx, core, rows, class_start (host), out, changed,
        # device, stream
        "gab_hindex_sweep": [_vp] * 4 + [_i64p, _vp, _vp, _int, _vp],
    },
    "coloring": {
        # row_ptr, col_idx, colors, active, hubs, n_hubs, nv, max_colors,
        # out, device, stream
        "gab_first_fit": [_vp] * 5 + [_i64, _i64, _int, _vp, _int, _vp],
    },
    "cgr_decode": {
        # words, nwords, then per entry: positions or lanes, their count, the
        # kind / zeta_k / min_itv_len, the outputs; device, stream
        "gab_cgr_gamma": [_vp, _i64, _vp, _i64, _int, _vp, _vp, _int, _vp],
        # words, nwords, data_p, counts, lane_v, base, lanes, tiles,
        # n_tiles, order, zeta_k, col, ncol, pfin
        "gab_cgr_residual": [_vp, _i64] + [_vp] * 4 + [_i64, _vp, _i64, _vp,
                                                       _int, _vp, _i64, _vp,
                                                       _int, _vp],
        "gab_cgr_interval": [_vp, _i64] + [_vp] * 4 + [_i64, _int, _vp, _vp,
                                                       _vp, _int, _vp],
        # res, row_ptr, nres, itv_ptr, left, length, itv_pre, nv, tile_row,
        # n_tiles, tile_slots, ne, col
        "gab_cgr_merge": [_vp] * 7 + [_i64, _vp, _i64, _i64, _i64, _vp, _int,
                                      _vp],
    },
    "vbyte_decode": {
        # bytes, nbytes, then the row arrays, their count, the output and its
        # length; device, stream
        # bytes, nbytes, key_start, counts, out_slot, rows, long_rows,
        # n_long, tiles, n_tiles, long_values, col, ncol, device, stream
        "gab_svb_decode": [_vp, _i64] + [_vp] * 3 + [_i64, _vp, _i64, _vp,
                                                     _i64, _i64, _vp, _i64,
                                                     _int, _vp],
        "gab_vgb_tags": [_vp, _i64] + [_vp] * 3 + [_i64, _vp, _i64, _vp, _i64,
                                                   _int, _vp, _i64, _int, _vp],
        # bytes, nbytes, tagpos, n_g, gbase, counts, out_slot, rows,
        # long_rows, n_long, tiles, n_tiles, long_groups, col, ncol
        "gab_vgb_values": [_vp, _i64, _vp, _i64] + [_vp] * 3 + [
            _i64, _vp, _i64, _vp, _i64, _int, _vp, _i64, _int, _vp],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location; raises when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from graphaibench_tpu_torch/csrc at "
        "first use")


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"gab_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source that has no library with its hash yet, all at
    once; return the libraries' paths by source stem. Each compiler
    report (``-Xptxas -v``: registers, spills) is kept beside its library
    with the suffix ``.log``."""
    nvcc = find_nvcc()
    libs = {Path(s).stem: _library_path(s) for s in SOURCES}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source in SOURCES:
        so = libs[Path(source).stem]
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((source, so, tmp, proc))
    failures = []
    for source, so, tmp, proc in running:
        try:
            out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            failures.append(f"nvcc timed out on {source}:\n{err}")
            continue
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {source} with code "
                            f"{proc.returncode}:\n{err}")
            continue
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use (with every
    other source). Raises ``RuntimeError`` when there is no CUDA device or
    no ``nvcc``."""
    if name in _LIBS:
        return _LIBS[name]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port's CUDA kernels need a CUDA device: "
            "torch.cuda.is_available() is False")
    lib = ctypes.CDLL(str(build()[name]))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.gab_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gab_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib
