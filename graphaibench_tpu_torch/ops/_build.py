"""Build and load the port's CUDA kernels.

The sources in ``graphaibench_tpu_torch/csrc`` are compiled with ``nvcc``
for sm_90a into one shared library with a plain C interface, at first
use, into ``build/torch_kernels/`` of the checkout, keyed by a hash of the
sources and flags. The library is loaded with ``ctypes``; pointers and the
stream travel as ``c_void_p``, sizes as ``c_int64``, and a kernel's
per-bucket arrays as ctypes arrays of those.

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
SOURCES = ("ell_spmm.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None


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


def build() -> Path:
    """Compile the sources unless a library with their hash exists;
    return the library's path. The compiler's report (``-Xptxas -v``:
    registers, spills) is kept beside it with the suffix ``.log``."""
    nvcc = find_nvcc()
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    so = BUILD_DIR / f"gab_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, srcs)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The kernels' library, built at first use. Raises ``RuntimeError``
    when there is no CUDA device or no ``nvcc``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port's CUDA kernels need a CUDA device: "
            "torch.cuda.is_available() is False")
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    vpp = ctypes.POINTER(vp)
    lib.gab_ell_spmm.argtypes = [
        vpp, vpp, vpp, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, vp, vp, vp,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, vp]
    lib.gab_ell_spmm.restype = ctypes.c_int
    lib.gab_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gab_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
