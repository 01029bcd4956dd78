"""The pull step of the analytics solvers: the hand-written CUDA kernel
``neighbor_reduce`` (``csrc/ell_pull.cu``) with its plain PyTorch version,
and the packing of per-edge values into the slot layout that it reads.

Counterpart of ``graphaibench_tpu/ops/segment.py::neighbor_reduce`` and
``pack_neighbor_edge_vals``, an XLA program of the JAX package:

    out_i = reduce over the neighbours j of row i of vals[j], or of
            vals[j] + ev_e (min, max) or vals[j] * ev_e (sum), e the edge
            (i, j)

with reduce one of min, max and sum, ``vals`` int32 or float32 of shape
(nv,), and the identity (the int32 extremes, +-inf, 0) on edgeless rows.
The per-edge values are float32, with float32 ``vals`` only: an (ne,)
array, or the per-bucket slot arrays of ``pack_neighbor_edge_vals``, which
a fixpoint solver packs once per solve instead of once per sweep. They are
refused with int32 ``vals``, where the JAX package's result is a dtype
promotion that no caller of either package asks for.

``neighbor_reduce`` takes the plain version for tensors on the CPU and
launches the kernel, once per call over every bucket, for tensors on a
CUDA device, or raises; ``LAUNCHES`` counts the launches. It needs the ELL
buckets, as the JAX function does: the solvers take their push route
(plain PyTorch scatters, on either device) on graphs without them. The
kernel stores the rows that have one virtual row and combines the pieces of
split rows (degree > 64) with atomics into an output whose ``g.zero_rows``
the wrapper fills with the identity. Min and max are exact, and so are
int32 sums; a float32 sum adds in another order than the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import (
    _check,
    _check_int4_ids,
    _empty_but,
    _launch_tail,
    _raise_on,
    _table,
)
from graphaibench_tpu_torch.ops.device_graph import DeviceGraph

LAUNCHES = {"neighbor_reduce": 0}

KINDS = {"min": 0, "max": 1, "sum": 2}                 # the kernel's `kind`
DTYPES = {torch.int32: 0, torch.float32: 1}            # the kernel's `dtype`


def identity(kind: str, dtype: torch.dtype):
    """The reduction's value on a row without neighbours (``_ident`` of the
    JAX module)."""
    if dtype.is_floating_point:
        return {"max": float("-inf"), "min": float("inf"), "sum": 0.0}[kind]
    info = torch.iinfo(dtype)
    return {"max": info.min, "min": info.max, "sum": 0}[kind]


def pack_neighbor_edge_vals(g: DeviceGraph, edge_vals: torch.Tensor,
                            kind: str = "min") -> tuple:
    """Per-edge values gathered once into the ELL slot layout: one flat
    (R*W,) array per bucket, in ``g.ell``'s order, 0 in the pad slots.
    ``kind`` is taken for symmetry with ``neighbor_reduce`` and changes
    nothing: the pads take the identity after the combine."""
    ev_pad = torch.cat([edge_vals, edge_vals.new_zeros(1)])
    return tuple(ev_pad[b.edge_id] for b in g.ell)


def _edge_slots(g: DeviceGraph, vals: torch.Tensor, edge_vals):
    """The per-bucket slot arrays of ``edge_vals`` (None, (ne,) or already
    packed), checked against ``vals`` and the graph."""
    if edge_vals is None:
        return None
    if vals.dtype != torch.float32:
        raise ValueError("edge values go with float32 vals only, not "
                         f"{vals.dtype}")
    if not isinstance(edge_vals, tuple):
        _check(g, edges=(edge_vals,))
        return pack_neighbor_edge_vals(g, edge_vals)
    if len(edge_vals) != len(g.ell):
        raise ValueError(f"{len(edge_vals)} packed edge-value arrays for "
                         f"{len(g.ell)} buckets")
    for b, ev in zip(g.ell, edge_vals):
        if (ev.dtype != torch.float32 or tuple(ev.shape) != (b.rows * b.width,)
                or not ev.is_contiguous() or ev.device != vals.device):
            raise ValueError(
                f"bucket of width {b.width}: packed edge values must be "
                f"contiguous float32 of shape ({b.rows * b.width},) on the "
                f"graph's device, got {ev.dtype} {tuple(ev.shape)}")
    return edge_vals


# ---- plain PyTorch version -------------------------------------------------

def neighbor_reduce_plain(g: DeviceGraph, vals: torch.Tensor, kind: str,
                          slots: tuple | None = None) -> torch.Tensor:
    """Per bucket: the slots' gather, the combine with the packed edge
    values ``slots``, the identity in the pads, the reduction over the
    slots and the scatter into the identity-filled output."""
    ident = identity(kind, vals.dtype)
    out = vals.new_full((g.nv,), ident)
    for i, b in enumerate(g.ell):
        rows = b.row_ids.long()
        vb = vals[b.nbr.view(b.rows, b.width).long()]
        if slots is not None:
            ev = slots[i].view(b.rows, b.width)
            vb = vb * ev if kind == "sum" else vb + ev
        pad = (torch.arange(b.width, device=vals.device)[None, :]
               >= b.valid[:, None])
        vb = vb.masked_fill(pad, ident)
        if kind == "min":
            out.scatter_reduce_(0, rows, vb.amin(1), "amin")
        elif kind == "max":
            out.scatter_reduce_(0, rows, vb.amax(1), "amax")
        else:
            out.index_add_(0, rows, vb.sum(1, dtype=vals.dtype))
    return out


# ---- the kernel's wrapper --------------------------------------------------

def neighbor_reduce(g: DeviceGraph, vals: torch.Tensor, kind: str,
                    edge_vals=None) -> torch.Tensor:
    """out[i] = reduce over j in N(i) of vals[j], optionally combined with
    the edge's value (``vals[j] + ev`` for min and max, ``vals[j] * ev``
    for sum); ``edge_vals`` is an (ne,) array or the per-bucket tuple of
    ``pack_neighbor_edge_vals``. N(i) are the row-i neighbours of the
    bucket layout, the out-neighbours: pass the reverse graph for
    in-neighbour pulls on directed graphs."""
    if kind not in KINDS:
        raise ValueError(f"unknown reduction {kind!r}: one of min, max, sum")
    if vals.dtype not in DTYPES:
        raise ValueError(f"vals must be int32 or float32, not {vals.dtype}")
    if not g.has_ell_layout:
        raise ValueError("neighbor_reduce needs the graph's ELL buckets "
                         "(to_device_graph(..., with_ell=True))")
    dev = _check(g, vectors=(vals,), dtype=vals.dtype)
    slots = _edge_slots(g, vals, edge_vals)
    if dev.type == "cpu":
        return neighbor_reduce_plain(g, vals, kind, slots)
    table = _table(g)
    _check_int4_ids(g, "neighbor_reduce")
    ev_ptrs = None
    if slots is not None:
        if any(ev.data_ptr() % 16 for ev in slots):
            raise ValueError("neighbor_reduce reads edge values four at a "
                             "time: packed arrays must be 16-byte aligned")
        ev_ptrs = (ctypes.c_void_p * len(slots))(
            *(slots[i].data_ptr() for i in table.order))
    lib = _build.load_library("ell_pull")
    out = _empty_but(g, vals, (g.nv,), identity(kind, vals.dtype))
    rc = lib.gab_neighbor_reduce(
        *table.args, ev_ptrs, vals.data_ptr(), out.data_ptr(), KINDS[kind],
        DTYPES[vals.dtype], *_launch_tail(vals))
    _raise_on(rc, lib, "neighbor_reduce",
              f"kind {kind}, {vals.dtype}, edge values {slots is not None}")
    LAUNCHES["neighbor_reduce"] += 1
    return out
