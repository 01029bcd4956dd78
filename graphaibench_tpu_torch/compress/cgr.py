"""CGR (Compressed Graph Representation) codec.

The port's own copy of ``graphaibench_tpu/compress/cgr.py`` (same names,
same bits, the native encoder and decoder copied into the port's
``native/src/gab_native.cpp``; ``tests/test_torch_compress.py`` holds them
equal). ``compress/cgr_device.py`` decodes the stream on the device.

Format parity with the reference encoder (src/structure/cgr_encoder.cc):
per vertex v the bit array holds

  [gamma(degree)]                          if add_degree or res_seg_len==0
  [intervals]                              if use_interval:
      gamma(num_itv_segments - 1), then per segment (padded to
      itv_seg_len bits except the last): gamma(count), then per interval
      gamma(first: int2nat(left - v) for the segment's first, else gap
      left - prev_left - prev_len - 1) and gamma(len - min_itv_len)
  [residuals]:
      res_seg_len > 0: gamma(num_res_segments - 1), then per segment
      (padded to res_seg_len bits except the last): gamma(count), then
      zeta_k deltas (first int2nat(r - v), then r - prev - 1)
      res_seg_len == 0 ("unary mode"): plain zeta_k delta stream
  zero deltas between consecutive residuals are the -1 trick: gaps are
  encoded as (r_i - r_{i-1} - 1).

On disk (Compressor::write_compressed_graph): ``.edge.bin`` is the
concatenation of per-vertex bit arrays (each byte- or word- aligned per
the alignment option), ``.vertex.bin`` the int64 prefix offsets in the
alignment unit (bits / bytes / words).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphaibench_tpu_torch.compress.unary import (
    BitReader,
    BitWriter,
    gamma_len,
    int_2_nat,
    nat_2_int,
    read_gamma,
    read_zeta,
    write_gamma,
    write_zeta,
    zeta_len,
)
from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges


@dataclasses.dataclass(frozen=True)
class CgrConfig:
    zeta_k: int = 2
    use_interval: bool = False
    min_itv_len: int = 4
    itv_seg_len: int = 32
    res_seg_len: int = 256      # 0 => unsegmented "unary" stream
    add_degree: bool = False
    alignment: str = "bit"      # bit | byte | word

    @property
    def unit_bits(self) -> int:
        return {"bit": 1, "byte": 8, "word": 32}[self.alignment]


def _intervalize(adj: np.ndarray, min_itv_len: int):
    """Split a sorted adjacency list into maximal runs of consecutive ids
    (kept as intervals when >= min_itv_len) and leftover residuals."""
    itv_left, itv_len, residuals = [], [], []
    i, n = 0, len(adj)
    while i < n:
        j = i + 1
        while j < n and adj[j - 1] + 1 == adj[j]:
            j += 1
        run = j - i
        if min_itv_len and run >= min_itv_len:
            itv_left.append(int(adj[i]))
            itv_len.append(run)
        else:
            residuals.extend(int(x) for x in adj[i:j])
        i = j
    return itv_left, itv_len, residuals


def _append_bits(w: BitWriter, sub: BitWriter):
    data = sub.getvalue()
    if sub.bit_length:
        w.write(int.from_bytes(data, "big") >> (len(data) * 8 - sub.bit_length),
                sub.bit_length)


def _encode_segmented(w: BitWriter, items, seg_len):
    """Segment machinery of encode_intervals/encode_residuals
    (cgr_encoder.cc:78-186): greedily close a segment when the next item
    would overflow seg_len bits; the trailing partial group MERGES into
    the last closed segment gap-coded (reference's "handle last partial
    segment"), so only complete segments are seg_len-padded. ``items``
    yields (bits_if_first_of_segment, bits_if_continuation,
    write_fn(writer, is_first_of_segment))."""
    segs: list[list] = []   # closed segments: lists of (item, is_first)
    cur: list = []
    cur_bits = 0
    for it in items:
        first_len, next_len, _ = it
        add = first_len if not cur else next_len
        if seg_len and cur and gamma_len(len(cur) + 1) + cur_bits + add > seg_len:
            segs.append(cur)
            cur = []
            cur_bits = 0
            add = first_len
        cur.append(it)
        cur_bits += add

    if not segs:
        segs.append(cur)
    else:
        # merge the trailing partial group gap-coded into the last
        # closed segment (its items are never "first")
        segs[-1] = segs[-1] + [(it[0], it[1], it[2], False) for it in cur]

    write_gamma(w, len(segs) - 1)
    for si, seg in enumerate(segs):
        sub = BitWriter()
        write_gamma(sub, len(seg))
        for ii, it in enumerate(seg):
            forced = it[3] if len(it) > 3 else None
            is_first = ii == 0 if forced is None else forced
            it[2](sub, is_first)
        if seg_len and si + 1 != len(segs):
            # pad to a MULTIPLE of seg_len: a single oversized code (the
            # case where the reference encoder asserts, cgr_encoder.cc
            # append_segment) occupies k consecutive segment slots
            sub.align(seg_len)
        _append_bits(w, sub)


def encode_vertex(v: int, adj: np.ndarray, cfg: CgrConfig) -> BitWriter:
    w = BitWriter()
    deg = len(adj)
    if cfg.add_degree or cfg.res_seg_len == 0:
        write_gamma(w, deg)
        if deg == 0:
            return w
    if cfg.use_interval:
        itv_left, itv_lens, residuals = _intervalize(adj, cfg.min_itv_len)
    else:
        itv_left, itv_lens, residuals = [], [], [int(x) for x in adj]

    if cfg.use_interval:
        items = []
        for i, (left, ln) in enumerate(zip(itv_left, itv_lens)):
            first_val = int_2_nat(left - v)
            gap_val = (left - itv_left[i - 1] - itv_lens[i - 1] - 1) if i else 0
            code_len_first = gamma_len(first_val) + gamma_len(ln - cfg.min_itv_len)
            code_len_next = gamma_len(gap_val) + gamma_len(ln - cfg.min_itv_len)

            def make_write(left=left, ln=ln, i=i):
                def wr(sub, is_first):
                    val = int_2_nat(left - v) if is_first else (
                        left - itv_left[i - 1] - itv_lens[i - 1] - 1)
                    write_gamma(sub, val)
                    write_gamma(sub, ln - cfg.min_itv_len)
                return wr

            items.append((code_len_first, code_len_next, make_write()))
        _encode_segmented(w, items, cfg.itv_seg_len)

    if cfg.res_seg_len == 0:
        # plain zeta delta stream
        if residuals:
            write_zeta(w, int_2_nat(residuals[0] - v), cfg.zeta_k)
            for a, b in zip(residuals, residuals[1:]):
                write_zeta(w, b - a - 1, cfg.zeta_k)
    else:
        items = []
        for i, r in enumerate(residuals):
            fval = int_2_nat(r - v)
            nval = (r - residuals[i - 1] - 1) if i else 0

            def make_write(r=r, i=i):
                def wr(sub, is_first):
                    val = int_2_nat(r - v) if is_first else (r - residuals[i - 1] - 1)
                    write_zeta(sub, val, cfg.zeta_k)
                return wr

            items.append((zeta_len(fval, cfg.zeta_k), zeta_len(nval, cfg.zeta_k),
                          make_write()))
        _encode_segmented(w, items, cfg.res_seg_len)
    return w


@dataclasses.dataclass
class CompressedGraph:
    nv: int
    ne: int
    offsets: np.ndarray     # (nv+1,) int64, in alignment units
    data: bytes
    cfg: CgrConfig

    @property
    def nbytes(self) -> int:
        return len(self.data)

    def compression_ratio(self) -> float:
        return (self.ne * 4) / max(len(self.data), 1)


def encode_graph(g: CSRGraph, cfg: CgrConfig = CgrConfig()) -> CompressedGraph:
    # CGR's interval + gap-1 residual coding requires sorted, duplicate-
    # free adjacency (the reference encodes cleaned graphs only;
    # sort_and_clean provides this). Fail loudly instead of corrupting.
    if g.ne:
        src, dst = g.coo()
        same_row = src[1:] == src[:-1]
        if (same_row & (dst[1:] <= dst[:-1])).any():
            raise ValueError(
                "CGR requires strictly increasing adjacency lists; run "
                "transforms.sort_and_clean(g) first")
    from graphaibench_tpu_torch import native
    if native.available():
        offsets, data = native.cgr_encode(g.row_ptr, g.col_idx, cfg)
        return CompressedGraph(nv=g.nv, ne=g.ne, offsets=offsets, data=data,
                               cfg=cfg)
    unit = cfg.unit_bits
    out = BitWriter()
    offsets = np.zeros(g.nv + 1, dtype=np.int64)
    for v in range(g.nv):
        bw = encode_vertex(v, g.neighbors(v), cfg)
        bw.align(unit) if unit > 1 else None
        data = bw.getvalue()
        nbits = bw.bit_length
        # append to the global stream
        if nbits:
            out.write(int.from_bytes(data, "big") >> (len(data) * 8 - nbits), nbits)
        offsets[v + 1] = offsets[v] + (nbits + unit - 1) // unit
    return CompressedGraph(nv=g.nv, ne=g.ne, offsets=offsets,
                           data=out.getvalue(), cfg=cfg)


def decode_vertex(cg: CompressedGraph, v: int, degree: int | None = None,
                  bit_offset: int | None = None) -> np.ndarray:
    cfg = cg.cfg
    if bit_offset is None:
        bit_offset = int(cg.offsets[v]) * cfg.unit_bits
    r = BitReader(cg.data, bit_offset)
    if cfg.add_degree or cfg.res_seg_len == 0:
        degree = read_gamma(r)
        if degree == 0:
            return np.empty(0, dtype=np.int32)

    intervals = []
    if cfg.use_interval:
        nseg = read_gamma(r) + 1
        base = r.pos
        for si in range(nseg):
            if si:
                used = r.pos - base
                r.pos = base + -(-used // cfg.itv_seg_len) * cfg.itv_seg_len
            cnt = read_gamma(r)
            prev_left = prev_len = None
            for i in range(cnt):
                if i == 0:
                    left = v + nat_2_int(read_gamma(r))
                else:
                    left = prev_left + prev_len + 1 + read_gamma(r)
                ln = read_gamma(r) + cfg.min_itv_len
                intervals.append((left, ln))
                prev_left, prev_len = left, ln

    residuals = []
    if cfg.res_seg_len == 0:
        n_res = degree - sum(ln for _, ln in intervals)
        if n_res > 0:
            first = v + nat_2_int(read_zeta(r, cfg.zeta_k))
            residuals.append(first)
            for _ in range(n_res - 1):
                residuals.append(residuals[-1] + 1 + read_zeta(r, cfg.zeta_k))
    else:
        nseg = read_gamma(r) + 1
        base = r.pos
        for si in range(nseg):
            if si:
                used = r.pos - base
                r.pos = base + -(-used // cfg.res_seg_len) * cfg.res_seg_len
            cnt = read_gamma(r)
            for i in range(cnt):
                if i == 0:
                    residuals.append(v + nat_2_int(read_zeta(r, cfg.zeta_k)))
                else:
                    residuals.append(residuals[-1] + 1 + read_zeta(r, cfg.zeta_k))

    out = list(residuals)
    for left, ln in intervals:
        out.extend(range(left, left + ln))
    return np.asarray(sorted(out), dtype=np.int32)


def decode_graph(cg: CompressedGraph, degrees: np.ndarray | None = None) -> CSRGraph:
    from graphaibench_tpu_torch import native
    # fast native path needs per-vertex output sizes up front
    if native.available() and degrees is not None:
        deg = np.asarray(degrees, dtype=np.int64)
        row_ptr = np.zeros(cg.nv + 1, dtype=np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        col = native.cgr_decode(cg.nv, cg.data, cg.offsets, row_ptr,
                                deg, cg.cfg)
        return CSRGraph(row_ptr=row_ptr, col_idx=col)
    src, dst = [], []
    for v in range(cg.nv):
        deg = None if degrees is None else int(degrees[v])
        adj = decode_vertex(cg, v, deg)
        src.extend([v] * len(adj))
        dst.extend(adj.tolist())
    return from_edges(np.asarray(src, dtype=np.int64),
                      np.asarray(dst, dtype=np.int64), cg.nv)
