"""CGR adjacency decoding on the device, through the kernels K12
(``ops/cgr_decode.py``, ``csrc/cgr_decode.cu``).

Counterpart of ``graphaibench_tpu/compress/cgr_device.py``. CGR is a
bit-granular stream of gamma and zeta_k codes; what makes a parallel decode
possible is the format's segmentation (compress/cgr.py): every closed
segment of a vertex's residuals (and intervals) is padded to exactly
``res_seg_len`` (``itv_seg_len``) bits, so segment j of vertex v starts at
``segs_base(v) + j * seg_len`` and decodes on its own.

``cgr_device_prep`` does the metadata work: the stream goes to the device;
``cgr_gamma`` reads every vertex's header and then every segment's count
(two small host syncs); for interval streams ``cgr_interval`` decodes the
interval segments, whose final positions give the residual headers, read by
``cgr_gamma`` again; the host builds the lane tables (a lane per (vertex,
segment), its first code's bit, count, vertex and first slot) and the row
pointers, derived from the counts, and ``cgr_residual``'s tables (tiles of
consecutive lanes, each tile's lanes by count). ``cgr_device_run`` is the
decode proper: one ``cgr_residual`` launch over every lane, the check of
the final positions, and, for interval streams, one ``cgr_merge`` (its tile
table built by the prep). There are no count buckets: a thread loops over
its own count.

Refused with ``StreamRefused`` (a ``ValueError``) by the prep, before the
residual pass, as the JAX package refuses them: an unsegmented (unary)
stream, bit positions past int32, a parse whose edge total is not ``ne``
or that gives a negative count or an interval shorter than
``min_itv_len`` (each row's slots must lie in order inside ``col``), an
oversized multi-slot interval segment; by the run, after the residual
pass, an oversized multi-slot residual segment
(``_check_closed_segments_fit``). The caller may then decode on the host.
Any other fault raises as it is: a wrapper's ``ValueError`` for its
operands, a kernel's ``RuntimeError``.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.ops import cgr_decode as K12


class StreamRefused(ValueError):
    """A stream whose shape the device decode does not take."""


def _check_closed_segments_fit(pfin, seg_start, lane_k, nsegs, lane_v,
                               seg_len: int, what: str):
    """The exact mis-parse witness: a closed segment must fit its seg_len
    slot. The encoder closes segments before they overflow, so the only
    violation is one item whose codes alone exceed the slot (the
    reference's multi-slot case); the first such segment of a vertex still
    starts where the stride says, so its measured length gives it away."""
    closed = lane_k < (nsegs[lane_v] - 1)
    if np.any((np.asarray(pfin, np.int64) - seg_start)[closed] > seg_len):
        raise StreamRefused(
            f"device CGR decode: oversized multi-slot {what} segment "
            f"(static {seg_len}-bit stride mis-parses this stream)")


def int32_on(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a contiguous int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def residual_tables_on(counts, device) -> dict:
    """``cgr_residual``'s tables (``K12.residual_tables``) for lanes of
    ``counts`` codes (a host array), built on the host and uploaded to
    ``device``."""
    return {k: t.to(device) for k, t in K12.residual_tables(
        torch.from_numpy(np.asarray(counts, np.int64))).items()}


def _lanes(nsegs: np.ndarray, segs_base: np.ndarray, seg_len: int):
    """(lane_v, lane_k, seg_start) of the (vertex, segment) lanes, in CSR
    order."""
    nv = len(nsegs)
    lane_v = np.repeat(np.arange(nv, dtype=np.int32), nsegs)
    starts = np.cumsum(nsegs) - nsegs
    lane_k = (np.arange(len(lane_v), dtype=np.int64) - starts[lane_v])
    seg_start = segs_base.astype(np.int64)[lane_v] + lane_k * seg_len
    return lane_v, lane_k, seg_start


def open_stream(cg, device):
    """(stream tensor, (nv,) int32 bit offsets on ``device``) of a CGR
    stream; StreamRefused for a unary stream or positions past int32."""
    cfg = cg.cfg
    if cfg.res_seg_len == 0:
        raise StreamRefused("device CGR decode: unsegmented (unary) stream")
    bits = np.asarray(cg.offsets, dtype=np.int64) * cfg.unit_bits
    if bits[-1] >= 2**31:
        raise StreamRefused("device CGR decode: stream too large for "
                            "int32 bit positions")
    return K12.stream_tensor(cg.data, device), int32_on(bits[:cg.nv], device)


def headers(stream, pos: torch.Tensor, add_degree: bool):
    """(nsegs int64, segs_base) on the host of the section headers at bit
    positions ``pos``: the optional degree's gamma, then gamma(nsegs - 1)
    (nsegs 0 for degree 0). StreamRefused for a count no stream can
    have."""
    kind = K12.HEADER_DEG if add_degree else K12.HEADER
    ns, base = K12.cgr_gamma(stream, pos, kind)
    nsegs = ns.cpu().numpy().astype(np.int64)
    if (nsegs < 0).any():
        raise StreamRefused("device CGR decode: stream parse mismatch "
                            "(negative segment count)")
    return nsegs, base.cpu().numpy()


def residual_lanes(stream, nsegs, segs_base, seg_len: int, device):
    """The residual lanes of the headers' segments: a dict of host tables
    (lane_v, lane_k, seg_start, counts) and device tensors (data_p,
    counts_d: the bit after each count and the count)."""
    lane_v, lane_k, seg_start = _lanes(nsegs, segs_base, seg_len)
    if len(lane_v):
        counts_d, data_p = K12.cgr_gamma(stream, int32_on(seg_start, device),
                                         K12.COUNT)
        counts = counts_d.cpu().numpy().astype(np.int64)
    else:
        counts_d = data_p = torch.zeros(0, dtype=torch.int32, device=device)
        counts = np.zeros(0, np.int64)
    return {"lane_v": lane_v, "lane_k": lane_k, "seg_start": seg_start,
            "counts": counts, "counts_d": counts_d, "data_p": data_p}


def lane_bases(counts: np.ndarray, lane_v: np.ndarray,
               row_ptr: np.ndarray) -> np.ndarray:
    """Each lane's first slot: its row's start plus the residuals of the
    row's earlier lanes."""
    nres = np.bincount(lane_v, weights=counts,
                       minlength=len(row_ptr) - 1).astype(np.int64)
    res_start = np.cumsum(nres) - nres
    gidx = np.cumsum(counts) - counts
    return (row_ptr[lane_v] + (gidx - res_start[lane_v])).astype(np.int64)


def residual_header_pos(itv_nsegs: np.ndarray,
                        ipfin: np.ndarray) -> np.ndarray:
    """The bit of each vertex's residual header: where its last (unpadded)
    interval segment ends (``ipfin``, a lane's final bit, the lanes in CSR
    order), or 0 for a vertex without an interval section, which has no
    residual one either (a stream with degrees, a vertex of degree 0): the
    positions rise but for those zeros."""
    istarts = np.cumsum(itv_nsegs) - itv_nsegs
    last = np.clip(istarts + itv_nsegs - 1, 0, None)
    return np.where(itv_nsegs > 0, ipfin[last] if len(ipfin) else 0, 0)


def _interval_sections(cg, stream, bit_off, device):
    """The interval sections of every vertex: their headers, counts and
    (left, len) pairs through ``cgr_interval``, the final positions checked.
    Returns (nsegs, segs_base) of the residual headers, read where each
    vertex's last interval segment ends, the intervals (vertex (n_itv,)
    host, left and length on the device, lengths on the host) and the
    interval lanes ``cgr_interval`` took (data_p, counts, lane_v, base on
    the device; None without intervals)."""
    cfg = cg.cfg
    nv = cg.nv
    itv_nsegs, ibase = headers(stream, bit_off, cfg.add_degree)
    ilane_v, ilane_k, iseg_start = _lanes(itv_nsegs, ibase,
                                          cfg.itv_seg_len)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    if len(ilane_v) == 0:
        # no vertex has a section (an add_degree stream, every degree 0)
        return (np.zeros(nv, np.int64), np.zeros(nv, np.int64),
                np.zeros(0, np.int32), empty, empty, np.zeros(0, np.int64),
                None)
    icnt_d, idata_p = K12.cgr_gamma(stream, int32_on(iseg_start, device),
                                    K12.COUNT)
    icnt = icnt_d.cpu().numpy().astype(np.int64)
    n_itv = int(icnt.sum())
    if n_itv > cg.ne or (icnt < 0).any():
        raise StreamRefused(f"device CGR decode: stream parse mismatch "
                            f"({n_itv} intervals for {cg.ne} edges)")
    lanes = (idata_p, icnt_d, int32_on(ilane_v, device),
             int32_on(np.cumsum(icnt) - icnt, device))
    left, length, ipfin = K12.cgr_interval(stream, *lanes, n_itv,
                                           cfg.min_itv_len)
    ipfin = ipfin.cpu().numpy()
    _check_closed_segments_fit(ipfin, iseg_start, ilane_k, itv_nsegs,
                               ilane_v, cfg.itv_seg_len, "interval")
    res_pos = residual_header_pos(itv_nsegs, ipfin)
    ns, segs_base = headers(stream, int32_on(res_pos, device), False)
    nsegs = np.where(itv_nsegs > 0, ns, 0)
    itv_vertex = np.repeat(ilane_v, icnt)
    return (nsegs, segs_base, itv_vertex, left, length,
            length.cpu().numpy().astype(np.int64), lanes)


def cgr_device_prep(cg, *, device="cuda") -> dict:
    """The metadata phase of the device decode (see the module docstring):
    everything ``cgr_device_run`` needs, on the device, so that the run
    does no host work but its validation fetch."""
    cfg = cg.cfg
    nv, ne = cg.nv, cg.ne
    stream, bit_off = open_stream(cg, device)
    itv_lanes = None
    if cfg.use_interval:
        (nsegs, segs_base, itv_vertex, left, length, itv_lens,
         itv_lanes) = _interval_sections(cg, stream, bit_off, device)
    else:
        nsegs, segs_base = headers(stream, bit_off, cfg.add_degree)
        itv_vertex, itv_lens = np.zeros(0, np.int32), np.zeros(0, np.int64)
    n_itv = len(itv_lens)
    lanes = residual_lanes(stream, nsegs, segs_base, cfg.res_seg_len, device)
    if (len(lanes["lane_v"]) == 0 and n_itv == 0) or ne == 0:
        if ne != 0:
            raise StreamRefused("device CGR decode: parsed zero segments "
                                "for a non-empty graph")
        return {"empty": True, "nv": nv, "device": device}
    counts = lanes["counts"]
    nres = np.bincount(lanes["lane_v"], weights=counts,
                       minlength=nv).astype(np.int64)
    deg = nres + np.bincount(itv_vertex, weights=itv_lens,
                             minlength=nv).astype(np.int64)
    if ((counts < 0).any() or (itv_lens < cfg.min_itv_len).any()
            or (deg < 0).any()):
        raise StreamRefused("device CGR decode: stream parse mismatch (a "
                            "negative count or degree, or an interval below "
                            f"{cfg.min_itv_len} ids)")
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    if row_ptr[-1] != ne:
        raise StreamRefused(f"device CGR decode: stream parse mismatch "
                            f"({row_ptr[-1]} != {ne} edges; oversized "
                            f"segment?)")
    base = lane_bases(counts, lanes["lane_v"], row_ptr)
    prep = {"empty": False, "device": device, "nv": nv, "ne": ne,
            "zeta_k": cfg.zeta_k, "seg_len": cfg.res_seg_len,
            "stream": stream, "row_ptr": row_ptr, "n_itv": n_itv,
            "data_p": lanes["data_p"], "counts": lanes["counts_d"],
            "lane_v_d": int32_on(lanes["lane_v"], device),
            "base": int32_on(base, device),
            "lane_v": lanes["lane_v"], "lane_k": lanes["lane_k"],
            "seg_start": lanes["seg_start"], "nsegs": nsegs,
            "bit_off": bit_off, "itv_lanes": itv_lanes,
            "min_itv_len": cfg.min_itv_len,
            "res_tables": residual_tables_on(counts, device)}
    if n_itv:
        itv_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(itv_vertex, minlength=nv))])
        prep.update({
            "row_ptr_d": int32_on(row_ptr, device),
            "nres": int32_on(nres, device),
            "itv_ptr": int32_on(itv_ptr, device),
            "left": left, "length": length,
            "itv_pre": int32_on(np.concatenate([[0], np.cumsum(itv_lens)]),
                           device)})
        prep["merge_tables"] = {
            "tile_row": K12.merge_tile_rows(prep["row_ptr_d"], ne)}
    return prep


def cgr_device_run(prep: dict):
    """The decode proper: (row_ptr, host int64 (nv + 1,); col_idx, (ne,)
    int32 on the device). The final positions come back to the host once,
    for the oversized-segment check."""
    if prep["empty"]:
        return (np.zeros(prep["nv"] + 1, np.int64),
                torch.zeros(0, dtype=torch.int32, device=prep["device"]))
    col, pfin = K12.cgr_residual(prep["stream"], prep["data_p"],
                                 prep["counts"], prep["lane_v_d"],
                                 prep["base"], prep["ne"], prep["zeta_k"],
                                 **prep["res_tables"])
    _check_closed_segments_fit(pfin.cpu().numpy(), prep["seg_start"],
                               prep["lane_k"], prep["nsegs"], prep["lane_v"],
                               prep["seg_len"], "residual")
    if prep["n_itv"]:
        col = K12.cgr_merge(col, prep["row_ptr_d"], prep["nres"],
                            prep["itv_ptr"], prep["left"], prep["length"],
                            prep["itv_pre"], **prep["merge_tables"])
    return prep["row_ptr"], col


def cgr_decode_device(cg, *, device="cuda") -> CSRGraph:
    """Decode a CompressedGraph on ``device`` into a host CSRGraph. The
    degrees are derived from the segments' counts: no side file. Raises
    StreamRefused for the stream shapes the device route refuses (the
    module docstring); the caller may decode those on the host."""
    row_ptr, col = cgr_device_run(cgr_device_prep(cg, device=device))
    return CSRGraph(row_ptr=row_ptr, col_idx=col.cpu().numpy())
