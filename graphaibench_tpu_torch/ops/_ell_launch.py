"""What the wrappers of the bucket passes share (``ops/fused_gat.py``,
``ops/ell_edge.py``; kernels in ``csrc/fused_gat.cu`` and
``csrc/ell_edge.cu`` over ``csrc/ell_table.cuh``): the per-bucket pointer
table kept on the graph, operand checks, the shape of a wide pass, outputs
in which only the rows no kernel stores to are initialised, and the
launch's tail arguments."""

from __future__ import annotations

import ctypes

import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.ell_spmm import MAX_BUCKETS

_MAX_TILE_V = 32                      # a group is at most one warp


class _Table:
    """The per-bucket pointer, row-count and width arrays of a graph in
    launch order (widest bucket first), validated once. It is kept on the
    graph (``g.launch_tables``), whose tensors' addresses it holds, and
    lives as long as the graph."""

    def __init__(self, g: DeviceGraph):
        if not g.has_ell_layout:
            raise ValueError("DeviceGraph has no ELL buckets (no edges)")
        if len(g.ell) > MAX_BUCKETS:
            raise ValueError(f"{len(g.ell)} buckets, the kernels' table "
                             f"holds {MAX_BUCKETS}")
        buckets = sorted(g.ell, key=lambda b: -b.width)
        for b in buckets:
            for t, shape in ((b.row_ids, (b.rows,)), (b.valid, (b.rows,)),
                             (b.nbr, (b.rows * b.width,)),
                             (b.edge_id, (b.rows * b.width,))):
                if (t.dtype != torch.int32 or tuple(t.shape) != shape
                        or not t.is_contiguous()
                        or t.device != g.is_split.device):
                    raise ValueError(
                        f"bucket of width {b.width}: ids must be contiguous "
                        f"int32 of shape {shape} on the graph's device")
        n = len(buckets)
        vp = ctypes.c_void_p
        self.args = (
            (vp * n)(*(b.row_ids.data_ptr() for b in buckets)),
            (vp * n)(*(b.nbr.data_ptr() for b in buckets)),
            (vp * n)(*(b.edge_id.data_ptr() for b in buckets)),
            (vp * n)(*(b.valid.data_ptr() for b in buckets)),
            (ctypes.c_int64 * n)(*(b.rows for b in buckets)),
            (ctypes.c_int32 * n)(*(b.width for b in buckets)),
            n, g.is_split.data_ptr())


def _table(g: DeviceGraph) -> _Table:
    table = g.launch_tables.get("ell_table")
    if table is None:
        table = g.launch_tables["ell_table"] = _Table(g)
    return table


def _check(g: DeviceGraph, vectors=(), matrices=(), edges=()) -> torch.device:
    """Every operand float32, contiguous, on the graph's device: (nv,)
    ``vectors``, (nv, F) ``matrices`` with one F, (ne,) per-edge arrays
    ``edges``. Returns the device."""
    dev = g.is_split.device
    f = matrices[0].shape[1] if matrices and matrices[0].dim() == 2 else None
    for t in (*vectors, *matrices, *edges):
        shape = ((g.nv,) if any(t is v for v in vectors)
                 else (g.ne,) if any(t is e for e in edges) else (g.nv, f))
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"expected float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.device != dev:
            raise ValueError("graph and operands must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the bucket passes run on cpu or cuda, not {dev}")
    return dev


def _wide_shape(nv: int, f: int, *mats, tile_floats) -> tuple[int, int, int]:
    """(tile_v, vec, tiles) of a wide pass: V = float4 when F % 4 == 0
    and every matrix is aligned to 16 bytes, else float; a tile has at
    most 32 columns of V, and ``tile_floats(nv, f)`` feature columns in
    the float4 instantiation (each pass has its rule)."""
    vec = int(f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in mats))
    tile_v = (tile_floats(nv, f) // 4 if vec else min(f, _MAX_TILE_V))
    f_v = f // 4 if vec else f
    return tile_v, vec, -(-f_v // tile_v)


def _raise_on(rc: int, lib, name: str, detail: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({detail}): CUDA "
                           f"error {rc}: {lib.gab_cuda_error_string(rc).decode()}")


def _empty_but(g: DeviceGraph, like: torch.Tensor, shape, fill: float):
    """An uninitialised output in which only ``g.zero_rows`` (edgeless and
    split rows: the rows no kernel stores to) hold ``fill``."""
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    if g.zero_rows.numel():
        out.index_fill_(0, g.zero_rows, fill)
    return out


def _launch_tail(t: torch.Tensor) -> tuple:
    return (t.device.index, torch.cuda.current_stream(t.device).cuda_stream)
