"""Native (C++) host kernels with build-on-first-use ctypes bindings.

Counterpart of ``graphaibench_tpu/native``: the host-side hot loops that
feed the device path (CSR building, the stable key sort behind the
transpose permutation, ELL packing). The port keeps its own copy of the
source (``src/gab_native.cpp``) and compiles it once with ``g++`` into
``build/native/`` of the checkout, keyed by a hash of the source. Every
wrapper returns ``None`` when there is no toolchain, and its caller then
takes the numpy route: that is a host-side route, not a fallback of any
device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "gab_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "native")
_LIB = None
_TRIED = False


def _build_lib() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"gab_torch_native_{digest}.so")
    if os.path.exists(so):
        return so
    # pid-unique output so concurrent first uses never share a file;
    # os.replace is atomic
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
        "-march=native", _SRC, "-o", tmp,
    ]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """Returns the loaded ctypes library or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build_lib()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.build_csr.restype = ctypes.c_int
    lib.build_csr.argtypes = [i64, p_i64, p_i64, i64, p_i64, p_i32, ctypes.c_int]

    lib.stable_key_sort.restype = ctypes.c_int
    lib.stable_key_sort.argtypes = [i64, p_i32, i64, p_i32]

    lib.ell_pack_count.restype = i64
    lib.ell_pack_count.argtypes = [i64, p_i64, p_i32, ctypes.c_int, i64, p_i64]
    lib.ell_pack_fill.restype = ctypes.c_int
    lib.ell_pack_fill.argtypes = [
        i64, p_i32, p_i64, p_i64, p_i32, ctypes.c_void_p, i64, p_i32,
        ctypes.c_int, i64, p_i32, p_i32, p_i32, p_i64, p_i64,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return get_lib() is not None


# ---- high-level wrappers --------------------------------------------------

def build_csr(src: np.ndarray, dst: np.ndarray, nv: int, *,
              sort_neighbors: bool = True):
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    row_ptr = np.zeros(nv + 1, dtype=np.int64)
    col_idx = np.zeros(len(src), dtype=np.int32)
    lib.build_csr(len(src), src, dst, nv, row_ptr, col_idx, int(sort_neighbors))
    return row_ptr, col_idx


def stable_key_sort(keys: np.ndarray, nkeys: int):
    """perm = stable argsort of small-int keys (ties keep input order),
    or None without the toolchain. O(n) counting sort — replaces
    np.lexsort for the transpose-edge permutation (src-major COO sorted
    stably by dst == (dst, src) lex order)."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    perm = np.empty(len(keys), dtype=np.int32)
    rc = lib.stable_key_sort(len(keys), keys, int(nkeys), perm)
    if rc != 0:  # out-of-range key: caller's contract violated
        raise ValueError("stable_key_sort: key outside [0, nkeys)")
    return perm


def ell_pack(targets, starts, counts, col, eid, sentinel: int,
             widths, split: int):
    """Pack grouped rows into width-bucketed ELL matrices in one native
    pass (device_graph._virtual_rows + _pack_buckets semantics): row r
    supplies ``counts[r]`` entries of ``col``/``eid`` from position
    ``starts[r]``, split into <=split-wide virtual rows targeting
    ``targets[r]``. Returns [(width, row_ids, nbr, edge_id), ...] with
    empty width classes omitted, or None without the toolchain.
    ``eid=None`` means identity edge ids; pad slots get nbr=0,
    edge_id=sentinel."""
    lib = get_lib()
    if lib is None:
        return None
    targets = np.ascontiguousarray(targets, np.int32)
    starts = np.ascontiguousarray(starts, np.int64)
    counts = np.ascontiguousarray(counts, np.int64)
    col = np.ascontiguousarray(col, np.int32)
    w = np.ascontiguousarray(widths, np.int32)
    # the C width-class scan (`while widths[wi] < l`) relies on the last
    # width covering every chunk length; an uncovered length would walk
    # past widths[] and corrupt the output buffers
    if len(w) == 0 or w[-1] < split or np.any(np.diff(w) <= 0):
        raise ValueError(
            f"widths must be ascending and end with a value >= split "
            f"(got widths={w.tolist()}, split={split})")
    eid_ptr = None
    if eid is not None:
        eid = np.ascontiguousarray(eid, np.int64)
        eid_ptr = eid.ctypes.data_as(ctypes.c_void_p)
    out_counts = np.zeros(len(w), np.int64)
    total = lib.ell_pack_count(len(counts), counts, w, len(w), int(split),
                               out_counts)
    row_off = np.concatenate([[0], np.cumsum(out_counts)]).astype(np.int64)
    slot_off = np.concatenate(
        [[0], np.cumsum(out_counts * w.astype(np.int64))]).astype(np.int64)
    rows_flat = np.empty(int(total), np.int32)
    nbr_flat = np.empty(int(slot_off[-1]), np.int32)
    eid_flat = np.empty(int(slot_off[-1]), np.int32)
    lib.ell_pack_fill(len(counts), targets, starts, counts, col, eid_ptr,
                      int(sentinel), w, len(w), int(split), rows_flat,
                      nbr_flat, eid_flat, row_off, slot_off)
    out = []
    for i, wi in enumerate(w):
        if out_counts[i] == 0:
            continue
        # flat (rows*width,) slot arrays — the EllBucket storage layout
        out.append((int(wi),
                    rows_flat[row_off[i]:row_off[i + 1]],
                    nbr_flat[slot_off[i]:slot_off[i + 1]],
                    eid_flat[slot_off[i]:slot_off[i + 1]]))
    return out
