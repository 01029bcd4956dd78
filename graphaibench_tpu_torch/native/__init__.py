"""Native (C++) host kernels with build-on-first-use ctypes bindings.

Counterpart of ``graphaibench_tpu/native``: the host-side hot loops that
feed the device path (CSR building, the DAG orientation of triangle
counting, the stable key sort behind the transpose permutation, ELL
packing, the GraphSAINT frontier sampler, the CGR codec). The port keeps its own copy of the
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
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    c_int = ctypes.c_int

    lib.build_csr.restype = ctypes.c_int
    lib.build_csr.argtypes = [i64, p_i64, p_i64, i64, p_i64, p_i32, ctypes.c_int]

    lib.orient_count.restype = i64
    lib.orient_count.argtypes = [i64, p_i64, p_i32, p_i64]
    lib.orient_fill.restype = None
    lib.orient_fill.argtypes = [i64, p_i64, p_i32, p_i64, p_i32]

    lib.stable_key_sort.restype = ctypes.c_int
    lib.stable_key_sort.argtypes = [i64, p_i32, i64, p_i32]

    lib.saint_sample.restype = i64
    lib.saint_sample.argtypes = [i64, p_i64, p_i32, p_i64, i64, i64, i64, i64,
                                 ctypes.c_uint64, p_i32]

    lib.ell_pack_count.restype = i64
    lib.ell_pack_count.argtypes = [i64, p_i64, p_i32, ctypes.c_int, i64, p_i64]
    lib.ell_pack_fill.restype = ctypes.c_int
    lib.ell_pack_fill.argtypes = [
        i64, p_i32, p_i64, p_i64, p_i32, ctypes.c_void_p, i64, p_i32,
        ctypes.c_int, i64, p_i32, p_i32, p_i32, p_i64, p_i64,
    ]
    lib.cgr_encode_graph.restype = i64
    lib.cgr_encode_graph.argtypes = [
        i64, p_i64, p_i32, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
        p_i64, ctypes.c_void_p, i64,
    ]
    lib.cgr_decode_graph.restype = i64
    lib.cgr_decode_graph.argtypes = [
        i64, p_u8, p_i64, p_i64, ctypes.c_void_p, c_int, c_int, c_int, c_int,
        c_int, c_int, c_int, p_i32,
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


def orientation(row_ptr: np.ndarray, col_idx: np.ndarray):
    """The degree-ordered DAG of a CSR graph as (row_ptr int64, col_idx
    int32), rows in their input order, or None without the toolchain."""
    lib = get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int64)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    nv = len(row_ptr) - 1
    new_rp = np.zeros(nv + 1, dtype=np.int64)
    ne = lib.orient_count(nv, row_ptr, col_idx, new_rp)
    new_ci = np.zeros(ne, dtype=np.int32)
    lib.orient_fill(nv, row_ptr, col_idx, new_rp, new_ci)
    return new_rp, new_ci


def cgr_encode(row_ptr, col_idx, cfg):
    """(offsets int64 in ``cfg``'s alignment units, stream bytes) of a CSR
    graph with strictly increasing rows, or None without the toolchain."""
    lib = get_lib()
    if lib is None:
        return None
    nv = len(row_ptr) - 1
    offsets = np.zeros(nv + 1, dtype=np.int64)
    args = (nv, np.ascontiguousarray(row_ptr, np.int64),
            np.ascontiguousarray(col_idx, np.int32), cfg.zeta_k,
            int(cfg.use_interval), cfg.min_itv_len, cfg.itv_seg_len,
            cfg.res_seg_len, int(cfg.add_degree), cfg.unit_bits, offsets)
    nbytes = lib.cgr_encode_graph(*args, None, 0)
    out = np.zeros(nbytes, dtype=np.uint8)
    lib.cgr_encode_graph(*args, out.ctypes.data_as(ctypes.c_void_p), nbytes)
    return offsets, out.tobytes()


def cgr_decode(nv, data: bytes, offsets, row_ptr_out, degrees, cfg):
    """col_idx (int32) of a CGR stream decoded into the rows of
    ``row_ptr_out``, or None without the toolchain; raises ValueError when
    a row decodes to another length than ``degrees`` gives it."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    col_out = np.zeros(int(row_ptr_out[-1]), dtype=np.int32)
    deg_ptr = None
    if degrees is not None:
        degrees = np.ascontiguousarray(degrees, np.int64)
        deg_ptr = degrees.ctypes.data_as(ctypes.c_void_p)
    bad = lib.cgr_decode_graph(
        nv, buf, np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(row_ptr_out, np.int64), deg_ptr, cfg.zeta_k,
        int(cfg.use_interval), cfg.min_itv_len, cfg.itv_seg_len,
        cfg.res_seg_len, int(cfg.add_degree), cfg.unit_bits, col_out)
    if bad:
        raise ValueError(f"{bad} vertices decoded with another degree")
    return col_out


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


def saint_sample(row_ptr, col_idx, train_nodes, n, m, clip, seed):
    """Sorted unique vertices of one GraphSAINT frontier sample (m seeds
    from ``train_nodes``, n - m weighted expansions), or None without the
    toolchain."""
    lib = get_lib()
    if lib is None:
        return None
    nv = len(row_ptr) - 1
    out = np.zeros(min(nv, n + m), dtype=np.int32)
    k = lib.saint_sample(
        nv, np.ascontiguousarray(row_ptr, np.int64),
        np.ascontiguousarray(col_idx, np.int32),
        np.ascontiguousarray(train_nodes, np.int64), len(train_nodes),
        n, m, clip, seed, out)
    return out[:k].astype(np.int64)
