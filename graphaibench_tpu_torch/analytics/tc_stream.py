"""Triangle counting and BFS directly on a CGR-compressed graph, never
holding the whole graph's CSR.

Counterpart of ``graphaibench_tpu/analytics/tc_stream.py``. The reference
iterates compressed neighbourhoods on the fly (the ``N_cgr`` accessors,
graph.h:213-238; tc_omp_compressed.cc; bfs_gcgt_cta.cuh). Here:

- the compressed stream stays on the device, with its residual lanes built
  once from the header and count passes (``cgr_gamma``; O(segments), never
  O(edges));
- a block of consecutive vertices decodes through ``cgr_residual`` over its
  own lanes only, into a buffer the size of its edges (per-vertex offsets
  give random access);
- each decoded block is DAG-filtered by a few tensor ops (degree-then-id
  rank, the orientation of ``graph/transforms.py``: any total order counts
  each triangle once) and stays sorted, since CGR lists are strictly
  increasing;
- the triangles of a block pair (I, J) are K9's count (``ops/tc_count.py``)
  over a local CSR whose rows are I's DAG rows and then J's, the edges
  going from u in I to ``nI + (v - jlo)``, the rows holding global ids.

The JAX package's dense packing (``_dag_pack``) and compare-all
(``_count_edges``) exist for the TPU and are not carried; so are not its
block splits, which bound that dense matrix: the port's blocks are the
equal-edge ranges of ``block_bytes / 8`` edges. Device memory holds the
stream, its lane tables, and two blocks' decoded and DAG rows with one
pair's edge list, and besides them each ``dag_block``'s int64 temporaries
(the rows, ids and degrees of a whole block): at rmat(19, 16), in 4
blocks, the peak was 4.9 times the CSR's bytes on an H100, so this route
does not yet hold less than the CSR. Plain (non-interval) segmented
streams only: the others raise ``StreamRefused`` and the caller decodes,
then counts. Each block is checked once, on its first decode, for an
oversized segment, which raises ``StreamRefused`` too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graphaibench_tpu_torch.compress import cgr_device as CD
from graphaibench_tpu_torch.ops import cgr_decode as K12
from graphaibench_tpu_torch.ops import tc_count as K9

DEFAULT_BLOCK_BYTES = 32 << 20


@dataclasses.dataclass
class CgrStream:
    """A compressed stream on the device and its residual lanes (built once
    from the header and count passes)."""

    nv: int
    ne: int
    zeta_k: int
    seg_len: int
    stream: torch.Tensor       # the stream's bytes (``K12.stream_tensor``)
    deg: np.ndarray            # (nv,) int64, derived from the counts
    deg_d: torch.Tensor        # (nv,) int32 on the device (rank compares)
    row_ptr: np.ndarray        # (nv + 1,) int64
    lane_start: np.ndarray     # (nv + 1,) first lane of each vertex
    lane_v: np.ndarray         # (L,) owning vertex (host, for the check)
    lane_k: np.ndarray         # (L,) segment index within its vertex
    seg_start: np.ndarray      # (L,) int64 first bit of the segment
    nsegs: np.ndarray          # (nv,) segments of each vertex
    data_p: torch.Tensor       # (L,) int32 bit after the count
    counts: torch.Tensor       # (L,) int32 residuals in the lane
    lane_v_d: torch.Tensor     # (L,) int32
    base: torch.Tensor         # (L,) int32 first slot in the whole CSR
    checked: set = dataclasses.field(default_factory=set)


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
    lanes = CD.residual_lanes(stream, nsegs, segs_base, cfg.res_seg_len,
                              device)
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
        seg_start=lanes["seg_start"], nsegs=nsegs, data_p=lanes["data_p"],
        counts=lanes["counts_d"], lane_v_d=CD.int32_on(lane_v, device),
        base=CD.int32_on(CD.lane_bases(counts, lane_v, row_ptr), device))


def block_bounds(st: CgrStream, block_bytes: int) -> list[tuple[int, int]]:
    """Consecutive vertex ranges, each ending at the first vertex that
    takes it to ``block_bytes / 8`` edges (at least 4,096), as the JAX
    package's first cut."""
    cum = st.row_ptr
    target = max(block_bytes // 8, 1 << 12)
    out, lo = [], 0
    while lo < st.nv:
        hi = int(np.searchsorted(cum, cum[lo] + target, "left"))
        hi = max(lo + 1, min(hi, st.nv))
        out.append((lo, hi))
        lo = hi
    return out


def decode_block(st: CgrStream, vlo: int, vhi: int) -> torch.Tensor:
    """The neighbour ids (global) of vertices [vlo, vhi), rows in order, as
    one ``cgr_residual`` launch over the block's lanes; the rows' bounds
    are ``st.row_ptr[vlo:vhi + 1] - st.row_ptr[vlo]``."""
    l0, l1 = int(st.lane_start[vlo]), int(st.lane_start[vhi])
    off = int(st.row_ptr[vlo])
    col, pfin = K12.cgr_residual(
        st.stream, st.data_p[l0:l1], st.counts[l0:l1], st.lane_v_d[l0:l1],
        st.base[l0:l1] - off, int(st.row_ptr[vhi]) - off, st.zeta_k)
    if (vlo, vhi) not in st.checked:
        CD._check_closed_segments_fit(
            pfin.cpu().numpy(), st.seg_start[l0:l1], st.lane_k[l0:l1],
            st.nsegs, st.lane_v[l0:l1], st.seg_len, "residual")
        st.checked.add((vlo, vhi))
    return col


def _rows(st: CgrStream, vlo: int, vhi: int) -> torch.Tensor:
    """The local row of every edge of the block."""
    dev = st.deg_d.device
    return torch.repeat_interleave(
        torch.arange(vhi - vlo, device=dev), st.deg_d[vlo:vhi].long(),
        output_size=int(st.row_ptr[vhi] - st.row_ptr[vlo]))


def dag_block(st: CgrStream, vlo: int, vhi: int):
    """The block's DAG rows: (row_ptr (n + 1,) int32, ids (m,) int32 global,
    sorted in each row, the local row of each kept edge (m,) int64). An
    edge u -> v is kept iff (deg u, u) < (deg v, v)."""
    col = decode_block(st, vlo, vhi)
    dev = col.device
    u = _rows(st, vlo, vhi) + vlo
    v = col.long()
    du, dv = st.deg_d[u], st.deg_d[v]
    keep = (du < dv) | ((du == dv) & (u < v))
    u_loc = u[keep] - vlo
    rp = torch.zeros(vhi - vlo + 1, dtype=torch.int64, device=dev)
    rp[1:] = torch.cumsum(torch.bincount(u_loc, minlength=vhi - vlo), 0)
    return rp.to(torch.int32), col[keep], u_loc


def triangle_count_streaming(cg, *, block_bytes: int = DEFAULT_BLOCK_BYTES,
                             device="cuda") -> tuple[int, dict]:
    """The exact triangle count of an undirected (symmetric) graph given as
    a CGR stream, counted on ``device`` block pair by block pair, the
    whole graph's CSR never held. Returns (count, stats: blocks, the pairs
    counted (one K9 launch each on a CUDA device), nv, ne)."""
    st = open_cgr_stream(cg, device=device)
    bounds = block_bounds(st, block_bytes)
    stats = {"blocks": len(bounds), "pairs": 0, "nv": st.nv, "ne": st.ne}
    total = torch.zeros((), dtype=torch.int64, device=device)
    for ilo, ihi in bounds:
        rp_i, col_i, u_i = dag_block(st, ilo, ihi)
        v_i = col_i.long()
        n_i = ihi - ilo
        for jlo, jhi in bounds:
            sel = (v_i >= jlo) & (v_i < jhi)
            src = u_i[sel]
            if src.numel() == 0:
                continue
            if (jlo, jhi) == (ilo, ihi):
                rp, col, dst = rp_i, col_i, v_i[sel] - ilo
            else:
                rp_j, col_j, _ = dag_block(st, jlo, jhi)
                rp = torch.cat([rp_i, rp_j[1:] + rp_i[-1]])
                col = torch.cat([col_i, col_j])
                dst = n_i + v_i[sel] - jlo
            pair = K9.edges_between(rp, col, src, dst, id_bound=st.nv)
            if pair.src.numel():
                total += K9.tc_count(pair)
                stats["pairs"] += 1
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
            hit = (dist[col.long()] == level).to(torch.int32)
            reached = torch.zeros(vhi - vlo, dtype=torch.int32,
                                  device=device)
            reached.scatter_reduce_(0, _rows(st, vlo, vhi), hit,
                                    "amax")
            seg = dist[vlo:vhi]
            upd = (reached > 0) & (seg < 0)
            new[vlo:vhi] = torch.where(upd, level + 1, seg)
            moved |= upd.any()
        if not bool(moved):
            return dist
        dist = new
        level += 1
