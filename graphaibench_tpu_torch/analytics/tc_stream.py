"""Triangle counting and BFS directly on a CGR-compressed graph, never
holding the whole graph's CSR.

Counterpart of ``graphaibench_tpu/analytics/tc_stream.py``. The reference
iterates compressed neighbourhoods on the fly (the ``N_cgr`` accessors,
graph.h:213-238; tc_omp_compressed.cc; bfs_gcgt_cta.cuh). Here:

- the compressed stream stays on the device; its residual lanes are found
  once by the header and count passes (``cgr_gamma``) and their tables kept
  on the host, so the device holds the stream and O(nv) beside it;
- a block of consecutive vertices decodes through ``cgr_residual`` over its
  own lanes only, uploaded at its decode, into a buffer the size of its
  edges (per-vertex offsets give random access);
- each decoded block is DAG-filtered by a few int32 tensor ops
  (degree-then-id rank, the orientation of ``graph/transforms.py``: any
  total order counts each triangle once) and stays sorted, since CGR lists
  are strictly increasing;
- the triangles of a block pair (I, J) are K9's count (``ops/tc_count.py``)
  over a local CSR whose rows are I's DAG rows and then J's, the edges
  going from u in I to ``nI + (v - jlo)``, the rows holding global ids; a
  pair with no DAG edge from I into J is skipped before J is decoded.

The JAX package's dense packing (``_dag_pack``) and compare-all
(``_count_edges``) exist for the TPU and are not carried; so are not its
block splits, which bound that dense matrix. ``block_bytes`` means another
thing here: the device bytes of one block pair's work, beside the stream
and the O(nv) tables. A block edge takes about ``BLOCK_EDGE_BYTES`` at the
pair's peak (the decoded ids, the rows, the rank compare, the kept
indices, the pair's layout), so a block is the equal-edge range of
``block_bytes / BLOCK_EDGE_BYTES`` edges, where JAX's holds ``block_bytes /
8``; the default is 16 MiB, where JAX's is 32 MiB. Every array of a block
is int32 but the kept edges' and the sort's indices, and no tensor of a
pair lives into the next. Plain (non-interval) segmented streams only: the
others raise ``StreamRefused`` and the caller decodes, then counts. Each
block is checked once, on its first decode, for an oversized segment, which
raises ``StreamRefused`` too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphaibench_tpu_torch.compress import cgr_device as CD
from graphaibench_tpu_torch.ops import cgr_decode as K12
from graphaibench_tpu_torch.ops import tc_count as K9

DEFAULT_BLOCK_BYTES = 16 << 20
BLOCK_EDGE_BYTES = 32


@dataclasses.dataclass
class CgrStream:
    """A compressed stream on the device, with its residual lanes (found
    once by the header and count passes) in host tables."""

    nv: int
    ne: int
    zeta_k: int
    seg_len: int
    stream: torch.Tensor       # the stream's bytes (``K12.stream_tensor``)
    deg: np.ndarray            # (nv,) int64, derived from the counts
    deg_d: torch.Tensor        # (nv,) int32 on the device (rank compares)
    row_ptr: np.ndarray        # (nv + 1,) int64
    lane_start: np.ndarray     # (nv + 1,) first lane of each vertex
    lane_v: np.ndarray         # (L,) owning vertex (for the check)
    lane_k: np.ndarray         # (L,) segment index within its vertex
    seg_start: np.ndarray      # (L,) int64 first bit of the segment
    nsegs: np.ndarray          # (nv,) segments of each vertex
    # (4, L) int32: the bit after each lane's count, the count, the vertex,
    # the first slot in the whole CSR; uploaded a block at a time
    lanes: np.ndarray
    checked: set = dataclasses.field(default_factory=set)
    # (first lane, end lane) -> cgr_residual's tables of those lanes
    # (``K12.residual_tables``: the order, then the tiles), built on the
    # host at the block's first decode and uploaded with its lanes
    tables: dict = dataclasses.field(default_factory=dict)


def open_cgr_stream(cg, *, device="cuda") -> CgrStream:
    cfg = cg.cfg
    if cfg.use_interval:
        raise CD.StreamRefused("streaming: interval CGR streams unsupported "
                               "(decode-then-count handles them)")
    if cfg.res_seg_len == 0:
        raise CD.StreamRefused("streaming: unsegmented (unary) stream")
    nv, ne = cg.nv, cg.ne
    stream, bit_off = CD.open_stream(cg, device)
    nsegs, segs_base = CD.headers(stream, bit_off, cfg.add_degree)
    del bit_off
    lanes = CD.residual_lanes(stream, nsegs, segs_base, cfg.res_seg_len,
                              device)
    data_p = lanes.pop("data_p").cpu().numpy()
    del lanes["counts_d"]
    counts = lanes["counts"]
    deg = np.bincount(lanes["lane_v"], weights=counts,
                      minlength=nv).astype(np.int64)
    if (counts < 0).any() or int(deg.sum()) != ne:
        raise CD.StreamRefused(f"streaming: stream parse mismatch "
                               f"({int(deg.sum())} != {ne})")
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    lane_v = lanes["lane_v"]
    return CgrStream(
        nv=nv, ne=ne, zeta_k=cfg.zeta_k, seg_len=cfg.res_seg_len,
        stream=stream, deg=deg, deg_d=CD.int32_on(deg, device),
        row_ptr=row_ptr,
        lane_start=np.concatenate([[0], np.cumsum(nsegs)]).astype(np.int64),
        lane_v=lane_v, lane_k=lanes["lane_k"],
        seg_start=lanes["seg_start"], nsegs=nsegs,
        lanes=np.stack([data_p, counts, lane_v,
                        CD.lane_bases(counts, lane_v, row_ptr)]).astype(
                            np.int32))


def block_bounds(st: CgrStream, block_bytes: int) -> list[tuple[int, int]]:
    """Consecutive vertex ranges, each ending at the first vertex that
    takes it to ``block_bytes / BLOCK_EDGE_BYTES`` edges (at least 4,096),
    as the JAX package's first cut does with ``block_bytes / 8``."""
    cum = st.row_ptr
    target = max(block_bytes // BLOCK_EDGE_BYTES, 1 << 12)
    out, lo = [], 0
    while lo < st.nv:
        hi = int(np.searchsorted(cum, cum[lo] + target, "left"))
        hi = max(lo + 1, min(hi, st.nv))
        out.append((lo, hi))
        lo = hi
    return out


def _block_tables(st: CgrStream, l0: int, l1: int) -> np.ndarray:
    """``cgr_residual``'s order and tiles of the lanes [l0, l1), relative
    to l0, as one int32 array, built once."""
    if (l0, l1) not in st.tables:
        t = K12.residual_tables(torch.from_numpy(st.lanes[1, l0:l1]))
        st.tables[(l0, l1)] = np.concatenate([t["order"].numpy(),
                                              t["tiles"].numpy()])
    return st.tables[(l0, l1)]


def decode_block(st: CgrStream, vlo: int, vhi: int) -> torch.Tensor:
    """The neighbour ids (global, int32) of vertices [vlo, vhi), rows in
    order, as one ``cgr_residual`` launch over the block's lanes, whose
    tables (with the kernel's, built on the host at the block's first
    decode) are uploaded for it in one copy; the rows' bounds are
    ``st.row_ptr[vlo:vhi + 1] - st.row_ptr[vlo]``."""
    l0, l1 = int(st.lane_start[vlo]), int(st.lane_start[vhi])
    off = int(st.row_ptr[vlo])
    n = l1 - l0
    tab = st.lanes[:, l0:l1].copy()
    tab[3] -= off
    buf = torch.from_numpy(np.concatenate([
        tab.reshape(-1), _block_tables(st, l0, l1)])).to(st.stream.device)
    data_p, counts, lane_v, base = buf[:4 * n].view(4, n)
    col, pfin = K12.cgr_residual(st.stream, data_p, counts, lane_v, base,
                                 int(st.row_ptr[vhi]) - off, st.zeta_k,
                                 order=buf[4 * n:5 * n], tiles=buf[5 * n:])
    if (vlo, vhi) not in st.checked:
        CD._check_closed_segments_fit(
            pfin.cpu().numpy(), st.seg_start[l0:l1], st.lane_k[l0:l1],
            st.nsegs, st.lane_v[l0:l1], st.seg_len, "residual")
        st.checked.add((vlo, vhi))
    return col


def _rows(st: CgrStream, vlo: int, vhi: int) -> torch.Tensor:
    """The local row (int32) of every edge of the block."""
    return torch.repeat_interleave(
        st.deg_d[vlo:vhi], output_size=int(st.row_ptr[vhi] - st.row_ptr[vlo]))


def dag_block(st: CgrStream, vlo: int, vhi: int):
    """The block's DAG rows: (row_ptr (n + 1,), ids (m,) global, sorted in
    each row, the local row of each kept edge (m,)), all int32. An edge
    u -> v is kept iff (deg u, u) < (deg v, v)."""
    col = decode_block(st, vlo, vhi)
    rows = _rows(st, vlo, vhi)
    u_lt_v = rows < col - vlo
    # deg v - deg u, in place of two (m,) gathers held side by side
    diff = st.deg_d.index_select(0, col)
    diff -= st.deg_d[vlo:vhi].index_select(0, rows)
    keep = (diff > 0) | ((diff == 0) & u_lt_v)
    del u_lt_v, diff
    kept = keep.nonzero().squeeze(1)
    del keep
    u_loc = rows.index_select(0, kept)
    col = col.index_select(0, kept)
    del rows, kept
    n = vhi - vlo
    rp = torch.zeros(n + 1, dtype=torch.int32, device=col.device)
    rp[1:] = torch.cumsum(torch.bincount(u_loc, minlength=n), 0)
    return rp, col, u_loc


def triangle_count_streaming(cg, *, block_bytes: int = DEFAULT_BLOCK_BYTES,
                             device="cuda") -> tuple[int, dict]:
    """The exact triangle count of an undirected (symmetric) graph given as
    a CGR stream, counted on ``device`` block pair by block pair, the
    whole graph's CSR never held. Returns (count, stats: blocks, the pairs
    counted (one K9 launch each on a CUDA device), nv, ne)."""
    st = open_cgr_stream(cg, device=device)
    bounds = block_bounds(st, block_bytes)
    stats = {"blocks": len(bounds), "pairs": 0, "nv": st.nv, "ne": st.ne}
    starts = torch.tensor([hi for _, hi in bounds[:-1]], dtype=torch.int32,
                          device=device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    for ilo, ihi in bounds:
        rp_i, col_i, u_i = dag_block(st, ilo, ihi)
        n_i = ihi - ilo
        # the DAG edges of I into each block: a pair without any is skipped
        into = torch.bincount(torch.bucketize(col_i, starts, right=True,
                                              out_int32=True),
                              minlength=len(bounds)).tolist()
        for (jlo, jhi), n_into in zip(bounds, into):
            if n_into == 0:
                continue
            if (jlo, jhi) == (ilo, ihi):
                rp, col, first_j = rp_i, col_i, 0
            else:
                rp_j, col_j = dag_block(st, jlo, jhi)[:2]
                rp = torch.cat([rp_i, rp_j[1:] + rp_i[-1]])
                col = torch.cat([col_i, col_j])
                first_j = n_i
                del rp_j, col_j
            kept = ((col_i >= jlo) & (col_i < jhi)).nonzero().squeeze(1)
            src, dst = u_i.index_select(0, kept), col_i.index_select(0, kept)
            del kept
            dst += first_j - jlo
            pair = K9.edges_between(rp, col, src, dst, id_bound=st.nv)
            del rp, col, src, dst
            if pair.src.numel():
                total += K9.tc_count(pair)
                stats["pairs"] += 1
            del pair
        del rp_i, col_i, u_i
    return int(total), stats


def bfs_streaming(cg, source: int, *, block_bytes: int = DEFAULT_BLOCK_BYTES,
                  device="cuda") -> torch.Tensor:
    """Level-synchronous BFS pulling directly off the compressed stream:
    each level decodes the graph block by block, and a vertex not yet
    reached with a neighbour at this level gets the next one. int32 depths
    on ``device``, -1 where unreachable. A structurally symmetric graph
    (pull equals push)."""
    st = open_cgr_stream(cg, device=device)
    bounds = block_bounds(st, block_bytes)
    dist = torch.full((st.nv,), -1, dtype=torch.int32, device=device)
    dist[source] = 0
    level = 0
    while True:
        new = dist.clone()
        moved = torch.zeros((), dtype=torch.bool, device=device)
        for vlo, vhi in bounds:
            col = decode_block(st, vlo, vhi)
            hit = (dist.index_select(0, col) == level).to(torch.int32)
            del col
            reached = torch.zeros(vhi - vlo, dtype=torch.int32,
                                  device=device)
            reached.index_add_(0, _rows(st, vlo, vhi), hit)
            del hit
            seg = dist[vlo:vhi]
            upd = (reached > 0) & (seg < 0)
            new[vlo:vhi] = torch.where(upd, level + 1, seg)
            moved |= upd.any()
        if not bool(moved):
            return dist
        dist = new
        level += 1
