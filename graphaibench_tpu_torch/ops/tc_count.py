"""The DAG intersection count of triangle counting: the hand-written CUDA
kernel K9 (``csrc/tc_count.cu``) with its plain PyTorch version.

Counterpart of ``graphaibench_tpu/analytics/tc.py::_count_group``, an XLA
program of the JAX package:

    total = sum over the DAG edges (u, v) of |N+(u) ∩ N+(v)|

over the degree-ordered DAG of an undirected graph (each triangle once),
an id repeated in a row counted with its multiplicity, as compare-all
counts it.

``edges_between`` lays out, on the device, what the kernel reads: the CSR
(rows sorted, which the caller ensures) and the edges to count whose rows
are both non-empty, by destination, cut into tasks of at most
``TASK_EDGES`` edges of one destination, the tasks ordered by the class
that takes them (32, 16, 8 or 4 lanes a task, by the ids of the sources'
rows N+(u) the task streams). The edges are given apart from the rows and
their ids need not be row numbers: the streaming count
(``analytics/tc_stream.py``) counts a pair of vertex blocks so, the rows
holding global ids and the edges naming local rows. ``dag_edges`` moves a host DAG to the device once and lays out all
its edges so. ``tc_count`` takes the plain version for tensors on the CPU
and launches the kernel, once per call, for tensors on a CUDA device, or
raises; ``LAUNCHES`` counts the launches. Both return the total as a 0-d
int64 tensor on the DAG's device. The plain version is the JAX package's
compare-all over a sentinel-padded neighbour matrix (``pack_padded``),
edges grouped by the pow2 out-degree of their source, in chunks of a
bounded number of compares.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import _launch_tail, _raise_on

LAUNCHES = {"tc_count": 0}

# The kernel's tasks: at most TASK_EDGES edges of one destination. A task
# that streams more than CLASS_WORK[c] ids takes class c (32 >> c lanes);
# the rest take the last class (4 lanes).
TASK_EDGES = 32
CLASS_WORK = (256, 64, 16)
PLAIN_COMPARES = 1 << 25      # compares of one chunk of the plain version


@dataclasses.dataclass(frozen=True)
class DagEdges:
    """A DAG on the device, as K9 reads it."""

    row_ptr: torch.Tensor      # (nv + 1,) int32
    col_idx: torch.Tensor      # (ne,) int32, rows sorted ascending
    src: torch.Tensor          # (P,) int32 — the edges to count, by task,
                               # a task's edges one run of one destination
    dst: torch.Tensor          # (P,) int32
    tasks: torch.Tensor        # (T + 1,) int32: task t is edges [[t], [t + 1])
    class_start: tuple         # 5 ints: class c is tasks [[c], [c + 1])
    nv: int
    ne: int
    sentinel: int              # the plain version's pad, above every id


def dag_edges(row_ptr: np.ndarray, col_idx: np.ndarray, *, device) -> DagEdges:
    """The kernel's layout of a host DAG (CSR with sorted rows): the CSR
    moved to ``device`` and every edge laid out there by
    ``edges_between``."""
    row_ptr = np.asarray(row_ptr, np.int64)
    nv, ne = len(row_ptr) - 1, len(col_idx)
    if ne >= 2**31:
        raise ValueError("the DAG's edge count must fit int32")
    rp = torch.from_numpy(row_ptr.astype(np.int32)).to(device)
    col = torch.from_numpy(np.ascontiguousarray(col_idx, np.int32)).to(device)
    src = torch.repeat_interleave(rp[1:] - rp[:-1], output_size=ne)
    return edges_between(rp, col, src, col, id_bound=nv)


def edges_between(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, *,
                  id_bound: int) -> DagEdges:
    """The kernel's layout, built on the tensors' device, of the edges
    (src, dst) between rows of a CSR already there (int32, rows sorted,
    every id below ``id_bound``): those with both rows non-empty (the
    others close no triangle), stably by destination, cut into tasks of at
    most ``TASK_EDGES`` edges of one destination, the tasks stably by
    class. Every array is int32 but the sorts' orders and the tasks' work;
    two host syncs, for the kept edges and the class bounds (the streamed
    count lays out a block pair so, 948 of them on rmat(19, 16))."""
    rp = row_ptr.to(torch.int32)
    deg = rp[1:] - rp[:-1]
    src, dst = src.to(torch.int32), dst.to(torch.int32)
    keep = ((deg.index_select(0, src) > 0)
            & (deg.index_select(0, dst) > 0)).nonzero().squeeze(1)
    src, dst = src.index_select(0, keep), dst.index_select(0, keep)
    del keep
    order = torch.argsort(dst, stable=True)
    src, dst = src.index_select(0, order), dst.index_select(0, order)
    del order
    p = src.numel()
    dev = src.device
    # a task starts at a new destination and every TASK_EDGES edges after
    # it; task ids are below p, so the tasks' arrays are p long
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    head = torch.ones(p, dtype=torch.bool, device=dev)
    head[1:] = dst[1:] != dst[:-1]
    run = torch.cummax(torch.where(head, idx, 0), 0).values
    head |= (idx - run) % TASK_EDGES == 0
    del run
    task = torch.cumsum(head, 0, dtype=torch.int32) - 1
    work = torch.zeros(p, dtype=torch.int64, device=dev).index_add_(
        0, task, deg.index_select(0, src).long())
    bounds = torch.tensor(CLASS_WORK[::-1], dtype=torch.int64, device=dev)
    # the heaviest tasks in class 0
    ecls = (len(CLASS_WORK) - torch.bucketize(work, bounds, out_int32=True)
            ).index_select(0, task)
    counts = torch.zeros(len(CLASS_WORK) + 1, dtype=torch.int64,
                         device=dev).index_add_(0, ecls, head.long())
    del work, head
    order = torch.argsort(ecls, stable=True)
    src, dst = src.index_select(0, order), dst.index_select(0, order)
    task = task.index_select(0, order)
    del order, ecls
    # task t of the new order starts at its first edge; the rest stay p
    head = torch.ones(p, dtype=torch.bool, device=dev)
    head[1:] = task[1:] != task[:-1]
    del task
    tasks = torch.full((p + 1,), p, dtype=torch.int32, device=dev)
    tasks.scatter_reduce_(0, (torch.cumsum(head, 0) - 1), idx, "amin")
    del head, idx
    widest = deg.max().view(1).long() if deg.numel() else counts[:1] * 0
    *counts, widest = torch.cat([counts, widest]).tolist()
    if widest * TASK_EDGES >= 2**31:
        raise ValueError("a task's ids must fit int32: rows of at most "
                         f"{(2**31 - 1) // TASK_EDGES} ids")
    start = np.concatenate([[0], np.cumsum(counts)])
    return DagEdges(row_ptr=rp.contiguous(),
                    col_idx=col_idx.to(torch.int32).contiguous(),
                    src=src.contiguous(), dst=dst.contiguous(),
                    tasks=tasks[:int(start[-1]) + 1],
                    class_start=tuple(int(x) for x in start),
                    nv=row_ptr.numel() - 1, ne=col_idx.numel(),
                    sentinel=id_bound + 1)


# ---- plain PyTorch version -------------------------------------------------

def pack_padded(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(nv, W) int32 neighbour matrix padded with ``sentinel`` (> any id),
    W the largest degree (at least 1), and the (nv,) int64 degrees."""
    rp = row_ptr.long()
    deg = rp[1:] - rp[:-1]
    width = max(int(deg.max()) if deg.numel() else 0, 1)
    offs = torch.arange(width, device=rp.device)[None, :]
    in_row = offs < deg[:, None]
    nbr = torch.full(in_row.shape, sentinel, dtype=torch.int32,
                     device=rp.device)
    if col_idx.numel():
        pos = torch.where(in_row, rp[:-1, None] + offs, 0)
        nbr = torch.where(in_row, col_idx[pos], nbr)
    return nbr, deg


def count_group_plain(nbr: torch.Tensor, src_c: torch.Tensor,
                      dst_c: torch.Tensor, valid_c: torch.Tensor,
                      wa: int, sent: int | None = None) -> torch.Tensor:
    """The JAX package's ``_count_group``: over a chunk of DAG edges whose
    sources have out-degree <= ``wa``, the sum of |N(src) ∩ N(dst)| by
    compare-all, the invalid edges of the chunk left out. Real ids are
    below ``sent`` (default: the rows' count) and the padding is not.
    Returns a 0-d int64 tensor."""
    a = nbr[src_c.long()][:, :wa]
    b = nbr[dst_c.long()]
    if sent is None:
        sent = nbr.shape[0]
    eq = (a[:, :, None] == b[:, None, :]) & (a < sent)[:, :, None]
    return (eq & valid_c[:, None, None]).sum()


def tc_count_plain(dag: DagEdges) -> torch.Tensor:
    """The total by compare-all, edges grouped by the pow2 out-degree of
    their source (at least 8), as the JAX package groups them."""
    total = torch.zeros((), dtype=torch.int64, device=dag.src.device)
    if dag.src.numel() == 0:
        return total
    nbr, deg = pack_padded(dag.row_ptr, dag.col_idx, dag.sentinel)
    width = nbr.shape[1]
    src, dst = dag.src.long(), dag.dst.long()
    group = torch.ceil(torch.log2(deg[src].clamp(min=8).double())).long()
    for gid in torch.unique(group).tolist():
        sel = group == gid
        s_g, d_g = src[sel], dst[sel]
        wa = min(1 << gid, width)
        csize = max(1, PLAIN_COMPARES // (wa * width))
        for lo in range(0, s_g.numel(), csize):
            s_c, d_c = s_g[lo:lo + csize], d_g[lo:lo + csize]
            valid = torch.ones(s_c.numel(), dtype=torch.bool,
                               device=s_c.device)
            total += count_group_plain(nbr, s_c, d_c, valid, wa,
                                       dag.sentinel)
    return total


# ---- the kernel's wrapper --------------------------------------------------

def tc_count(dag: DagEdges) -> torch.Tensor:
    """The DAG's intersection total as a 0-d int64 tensor on its device:
    the plain version on the CPU, the kernel on a CUDA device."""
    dev = dag.src.device
    for t in (dag.row_ptr, dag.col_idx, dag.src, dag.dst, dag.tasks):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError("the DAG's arrays must be contiguous int32 on "
                             "one device")
    if dev.type == "cpu":
        return tc_count_plain(dag)
    if dev.type != "cuda":
        raise ValueError(f"tc_count runs on cpu or cuda, not {dev}")
    lib = _build.load_library("tc_count")
    total = torch.empty((), dtype=torch.int64, device=dev)
    starts = (ctypes.c_int64 * len(dag.class_start))(*dag.class_start)
    rc = lib.gab_tc_count(dag.row_ptr.data_ptr(), dag.col_idx.data_ptr(),
                          dag.src.data_ptr(), dag.dst.data_ptr(),
                          dag.tasks.data_ptr(), starts, total.data_ptr(),
                          *_launch_tail(dag.src))
    _raise_on(rc, lib, "tc_count",
              f"{dag.src.numel()} edges in {dag.tasks.numel() - 1} tasks")
    LAUNCHES["tc_count"] += 1
    return total
