"""The ELL SpMM: kernel K1 (CUDA C++, ``csrc/ell_spmm.cu``) and its plain
PyTorch version.

Counterpart of ``graphaibench_tpu/ops/pallas_spmm.py`` (``_bucket_kernel``
launched per bucket by ``spmm_ell_pallas``). For each degree bucket b of
``g.ell`` with slot weights ``w_slots[i]`` (flat (R*W,), aligned with the
bucket's ``nbr``):

    out[b.row_ids[r], :] += sum_j w_slots[i][r*W + j] * x[b.nbr[r*W + j], :]

``ell_spmm`` takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device, or raises; it never moves work
between devices. ``LAUNCHES`` counts kernel launches (one per bucket), so
a run can show that its SpMMs went through the kernel.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph

LAUNCHES = 0


def _check(g: DeviceGraph, w_slots, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] != g.nv:
        raise ValueError(f"x has {x.shape[0]} rows, the graph {g.nv}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if len(w_slots) != len(g.ell):
        raise ValueError(f"{len(w_slots)} slot-weight arrays for "
                         f"{len(g.ell)} buckets")
    for b, w in zip(g.ell, w_slots):
        if w.dtype != torch.float32 or tuple(w.shape) != tuple(b.nbr.shape):
            raise ValueError(
                f"bucket of width {b.width}: slot weights must be float32 of "
                f"shape {tuple(b.nbr.shape)}, got {w.dtype} {tuple(w.shape)}")
        if x.device != w.device or x.device != b.nbr.device or \
                x.device != b.row_ids.device:
            raise ValueError("graph, weights and x must be on one device")
        if not w.is_contiguous():
            raise ValueError("slot weights must be contiguous")
        if b.row_ids.dtype != torch.int32 or b.nbr.dtype != torch.int32:
            raise ValueError("bucket ids must be int32")


def ell_spmm_plain(g: DeviceGraph, w_slots, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: per bucket, gather (R, W, F), weight,
    sum over W, index_add into the output rows."""
    out = x.new_zeros((g.nv, x.shape[1]))
    for b, w in zip(g.ell, w_slots):
        nbr = b.nbr.view(b.rows, b.width)
        contrib = (w.view(b.rows, b.width, 1) * x[nbr]).sum(1)
        out.index_add_(0, b.row_ids, contrib)
    return out


def _ell_spmm_cuda(g: DeviceGraph, w_slots, x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    lib = _build.load_library()
    out = torch.zeros((g.nv, x.shape[1]), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f = x.shape[1]
    for b, w in zip(g.ell, w_slots):
        rc = lib.gab_ell_spmm_bucket(
            b.row_ids.data_ptr(), b.nbr.data_ptr(), w.data_ptr(),
            x.data_ptr(), out.data_ptr(), b.rows, b.width, f,
            x.device.index, stream)
        if rc != 0:
            msg = lib.gab_cuda_error_string(rc).decode()
            raise RuntimeError(
                f"ell_spmm kernel launch failed (bucket width {b.width}, "
                f"{b.rows} rows, F={f}): CUDA error {rc}: {msg}")
        LAUNCHES += 1
    return out


def ell_spmm(g: DeviceGraph, w_slots, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMM over every bucket of ``g``: the kernel on a CUDA device,
    the plain version on the CPU. ``w_slots`` is a tuple of per-bucket
    slot weights (``PackedEdgeW.fwd`` or ``.t``)."""
    _check(g, w_slots, x)
    if x.device.type == "cpu":
        return ell_spmm_plain(g, w_slots, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmm runs on cpu or cuda, not {x.device}")
    return _ell_spmm_cuda(g, w_slots, x)
