"""The CGR decode passes: the hand-written CUDA kernels K12
(``csrc/cgr_decode.cu``) with their plain PyTorch versions.

Counterpart of the XLA programs of ``graphaibench_tpu/compress/cgr_device.py``
(``_headers``, ``_counts``, ``_interval_pass``, ``_residual_pass``,
``_expand_intervals`` and the row sort of ``cgr_device_run``). A CGR stream
is a bit stream of Elias gamma and zeta_k codes, most significant bit
first; ``stream_tensor`` puts its bytes on the device, padded to whole
32-bit words and 16 bytes more, so that a 96-bit window read at any valid
position stays inside it. Every pass works on lanes given by bit positions:

- ``cgr_gamma``: a position a lane; one count gamma (kind ``COUNT``), a
  header's ``gamma(nsegs - 1)`` (``HEADER``, value nsegs), or the degree's
  gamma and then that header (``HEADER_DEG``: nsegs 0 for degree 0). Gives
  (value, the bit after what was read).
- ``cgr_residual``: a (vertex, segment) lane decodes ``count`` zeta_k codes
  (gamma for k = 1): the first is ``v + nat2int(x)``, the rest ``prev + x +
  1``; writes ``col[base + i]`` and the lane's final bit position. The
  kernel takes two tables (``residual_tables``): tiles of consecutive lanes,
  a block each, and the order in which a tile's threads take its lanes.
- ``cgr_interval``: an interval-segment lane decodes ``count`` (left, len)
  pairs of gammas: the first left ``v + nat2int(x)``, the rest ``prev_left +
  prev_len + 1 + x``, each len ``x + min_itv_len``; writes them at ``base +
  i`` and the lane's final bit position.
- ``cgr_merge``: per row, the sorted residual run (``nres[v]`` ids from
  ``row_ptr[v]`` of the residual buffer) merged with the row's intervals,
  expanded, into the row's slots of a new ``col``. The kernel works in
  tiles of ``MERGE_TILE_SLOTS`` slots of ``col``, each starting at the row
  its table (``merge_tile_rows``) gives.

The arithmetic is the same in both versions, garbage included: positions
and values in 64 bits, the leading-zero count capped at 31, a code's value
bits at 63, word reads clamped to the stream, values stored as int32. Each
wrapper takes the plain version for tensors on the CPU and launches its
kernel, once, for tensors on a CUDA device, or raises; ``LAUNCHES`` counts
the launches. The plain versions loop over a lane's codes in Python, every
lane at once, as the JAX package's scans do.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import _launch_tail, _raise_on

LAUNCHES = {"cgr_gamma": 0, "cgr_interval": 0, "cgr_residual": 0,
            "cgr_merge": 0}

COUNT, HEADER, HEADER_DEG = 0, 1, 2
PAD_BYTES = 16
# the slots of col a warp of cgr_merge fills
MERGE_TILE_SLOTS = 256
# cgr_residual's tiles: a tile ends where the lanes' first ids (their
# counts' prefix) cross a multiple of RESIDUAL_TILE_IDS or their indices
# one of RESIDUAL_TILE_LANES (the kernel's threads), so that its ids mostly
# fit the kernel's collected ones (kResSlots, 4,096); its bits mostly fit
# the staged words (kResWords, 2,048: 8 KB)
RESIDUAL_TILE_LANES = 256
RESIDUAL_TILE_IDS = 3072


def stream_tensor(data: bytes, device) -> torch.Tensor:
    """The stream's bytes as a uint8 tensor on ``device``, padded with zeros
    to a whole number of 32-bit words and 16 bytes more."""
    pad = (-len(data)) % 4 + PAD_BYTES
    buf = np.frombuffer(data + b"\x00" * pad, dtype=np.uint8)
    return torch.from_numpy(buf.copy()).to(device)


def _check(tensors, stream: torch.Tensor) -> torch.device:
    dev = stream.device
    if (stream.dtype != torch.uint8 or stream.dim() != 1
            or stream.numel() % 4 or stream.numel() < PAD_BYTES
            or not stream.is_contiguous()):
        raise ValueError("the stream must be a contiguous uint8 tensor of "
                         "whole words with its padding (stream_tensor)")
    for t in tensors:
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError("lane arrays must be contiguous 1-D int32 on the "
                             "stream's device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the CGR passes run on cpu or cuda, not {dev}")
    return dev


# ---- plain PyTorch versions ------------------------------------------------

def _words(stream: torch.Tensor) -> torch.Tensor:
    """The stream as big-endian 32-bit words, held in int64."""
    b = stream.view(-1, 4).long()
    return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]


def _window(words: torch.Tensor, p: torch.Tensor):
    """Bits [p, p + 64) as two 32-bit halves (int64), the word index
    clamped to the stream."""
    wi = (p >> 5).clamp(0, words.numel() - 3)
    s = p & 31
    w0, w1, w2 = words[wi], words[wi + 1], words[wi + 2]
    mask = 0xFFFFFFFF
    hi = ((w0 << s) | (w1 >> (32 - s))) & mask
    lo = ((w1 << s) | (w2 >> (32 - s))) & mask
    return hi, lo


def _first_bits(hi, lo, nb):
    """The first ``nb`` (1..63) bits of the window hi:lo."""
    short = hi >> (32 - nb.clamp(max=32))
    nl = nb.clamp(min=32)
    return torch.where(nb <= 32, short, (hi << (nl - 32)) | (lo >> (64 - nl)))


def _clz(hi):
    """Leading zeros of a 32-bit value held in int64, capped at 31."""
    _, e = torch.frexp(hi.double())
    return (32 - e.long()).clamp(max=31)


def _read_code(words, p, k: int):
    """(value, bits) of the zeta_k code (gamma for k = 1) at positions p."""
    hi, lo = _window(words, p)
    h = _clz(hi)
    if k == 1:
        nb = 2 * h + 1
        return _first_bits(hi, lo, nb) - 1, nb
    nb = ((h + 1) * k).clamp(max=63)
    hi2, lo2 = _window(words, p + h + 1)
    return _first_bits(hi2, lo2, nb) - 1, h + 1 + nb


def _nat2int(x):
    return torch.where((x & 1) == 1, -((x + 1) >> 1), x >> 1)


def _wrap32(x):
    """int64 -> int32 by its low 32 bits, as a C cast does."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def cgr_gamma_plain(stream, pos, kind: int):
    words = _words(stream)
    p = pos.long()
    x, nb = _read_code(words, p, 1)
    if kind == COUNT:
        return _wrap32(x), _wrap32(p + nb)
    if kind == HEADER:
        return _wrap32(x + 1), _wrap32(p + nb)
    p2 = p + nb
    ns, nb2 = _read_code(words, p2, 1)
    zero = x == 0
    return (_wrap32(torch.where(zero, 0, ns + 1)),
            _wrap32(torch.where(zero, p2, p2 + nb2)))


def _by_count(counts):
    """Lane order by count, largest first, and the counts in that order."""
    c = counts.long()
    order = torch.argsort(c, descending=True, stable=True)
    return order, c[order]


def cgr_residual_plain(stream, data_p, counts, lane_v, base, ne: int,
                       zeta_k: int):
    words = _words(stream)
    col = torch.zeros(ne, dtype=torch.int32, device=stream.device)
    order, c = _by_count(counts)
    p = data_p.long()[order]
    v = lane_v.long()[order]
    b = base.long()[order]
    prev = torch.zeros_like(p)
    steps = int(c[0]) if c.numel() else 0
    for i in range(steps):
        n = int((c > i).sum())
        x, nb = _read_code(words, p[:n], zeta_k)
        val = _wrap32(v[:n] + _nat2int(x) if i == 0
                      else prev[:n] + x + 1).long()
        col[b[:n] + i] = val.to(torch.int32)
        prev[:n] = val
        p[:n] += nb
    pfin = torch.empty_like(p)
    pfin[order] = p
    return col, _wrap32(pfin)


def cgr_interval_plain(stream, data_p, counts, lane_v, base, n_itv: int,
                       min_itv_len: int):
    words = _words(stream)
    dev = stream.device
    left = torch.zeros(n_itv, dtype=torch.int32, device=dev)
    length = torch.zeros(n_itv, dtype=torch.int32, device=dev)
    order, c = _by_count(counts)
    p = data_p.long()[order]
    v = lane_v.long()[order]
    b = base.long()[order]
    prev_left = torch.zeros_like(p)
    prev_len = torch.zeros_like(p)
    steps = int(c[0]) if c.numel() else 0
    for i in range(steps):
        n = int((c > i).sum())
        x1, nb1 = _read_code(words, p[:n], 1)
        x2, nb2 = _read_code(words, p[:n] + nb1, 1)
        lf = _wrap32(v[:n] + _nat2int(x1) if i == 0
                     else prev_left[:n] + prev_len[:n] + 1 + x1).long()
        ln = _wrap32(x2 + min_itv_len).long()
        left[b[:n] + i] = lf.to(torch.int32)
        length[b[:n] + i] = ln.to(torch.int32)
        prev_left[:n], prev_len[:n] = lf, ln
        p[:n] += nb1 + nb2
    pfin = torch.empty_like(p)
    pfin[order] = p
    return left, length, _wrap32(pfin)


def cgr_merge_plain(res, row_ptr, nres, itv_ptr, left, length, itv_pre):
    """Each residual goes to its index in the row plus the interval ids
    below it; each interval's ids to its place among the lengths before it
    plus the residuals below its left. Rows are found by keys row << 32 |
    id, which sort the residual runs and the intervals as wholes."""
    dev = res.device
    nv = nres.numel()
    rp = row_ptr.long()
    nr = nres.long()
    ip = itv_ptr.long()
    pre = itv_pre.long()
    col = torch.zeros_like(res)
    rows = torch.arange(nv, device=dev)
    # residuals
    rv = torch.repeat_interleave(rows, nr)
    rstart = torch.cumsum(nr, 0) - nr
    ri = torch.arange(rv.numel(), device=dev) - rstart[rv]
    rval = res.long()[rp[rv] + ri]
    iv = torch.repeat_interleave(rows, ip[1:] - ip[:-1])
    ikey = (iv << 32) | left.long()
    below = torch.searchsorted(ikey, (rv << 32) | rval)   # first interval >= r
    col[rp[rv] + ri + pre[below] - pre[ip[rv]]] = rval.to(torch.int32)
    # intervals, expanded
    rkey = (rv << 32) | rval
    j = torch.arange(iv.numel(), device=dev)
    nbelow = torch.searchsorted(rkey, ikey) - rstart[iv]
    pos0 = rp[iv] + pre[j] - pre[ip[iv]] + nbelow
    ln = length.long()
    owner = torch.repeat_interleave(j, ln)
    t = torch.arange(owner.numel(), device=dev) - (torch.cumsum(ln, 0)
                                                   - ln)[owner]
    col[pos0[owner] + t] = (left.long()[owner] + t).to(torch.int32)
    return col


# ---- the kernels' wrappers -------------------------------------------------

def _nwords(stream):
    return stream.numel() // 4


def cgr_gamma(stream: torch.Tensor, pos: torch.Tensor, kind: int):
    """(value, next bit) int32 at each position of ``pos``."""
    if kind not in (COUNT, HEADER, HEADER_DEG):
        raise ValueError(f"unknown kind {kind}")
    dev = _check((pos,), stream)
    if dev.type == "cpu":
        return cgr_gamma_plain(stream, pos, kind)
    lib = _build.load_library("cgr_decode")
    value = torch.empty_like(pos)
    nxt = torch.empty_like(pos)
    rc = lib.gab_cgr_gamma(stream.data_ptr(), _nwords(stream), pos.data_ptr(),
                           pos.numel(), kind, value.data_ptr(),
                           nxt.data_ptr(), *_launch_tail(stream))
    _raise_on(rc, lib, "cgr_gamma", f"{pos.numel()} positions")
    LAUNCHES["cgr_gamma"] += 1
    return value, nxt


def _lanes_ok(lanes, n_out: int, what: str):
    n = lanes[0].numel()
    if any(t.numel() != n for t in lanes):
        raise ValueError(f"{what}: lane arrays of different lengths")
    if n_out >= 2**31:
        raise ValueError(f"{what}: output past int32 slots")


def residual_tables(counts) -> dict:
    """``cgr_residual``'s tables for lanes of ``counts`` codes (int32, on
    any device; the tables on the same one): ``tiles`` (n_tiles + 1,), each
    tile's first lane and then the end: a tile ends where the lanes' first
    ids (their counts' exclusive prefix) cross a multiple of
    RESIDUAL_TILE_IDS or their indices one of RESIDUAL_TILE_LANES; and
    ``order`` (L,), the lanes tile by tile, in each the largest count first
    (a negative count as 0; ties in lane order). int32."""
    c = counts.long().clamp(min=0)
    n = c.numel()
    lane = torch.arange(n, device=c.device)
    key = ((torch.cumsum(c, 0) - c) // RESIDUAL_TILE_IDS
           + lane // RESIDUAL_TILE_LANES)
    cut = torch.nonzero(key.diff()).flatten() + 1
    tiles = torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n)])
    tile = torch.repeat_interleave(torch.arange(tiles.numel() - 1,
                                                device=c.device),
                                   tiles.diff(), output_size=n)
    order = torch.argsort(tile * 2**32 - c, stable=True)
    return {"tiles": tiles.to(torch.int32), "order": order.to(torch.int32)}


def cgr_residual(stream, data_p, counts, lane_v, base, ne: int, zeta_k: int,
                 *, tiles=None, order=None):
    """(col (ne,) int32, pfin (L,) int32): every lane's residuals written
    at ``col[base + i]``, slots no lane writes left as they were allocated
    (the callers' lanes cover every slot), and each lane's final bit.
    ``tiles`` and ``order``: the kernel's tables (``residual_tables``,
    which builds them on the card when they are not given); the plain
    version takes none."""
    lanes = (data_p, counts, lane_v, base)
    dev = _check(lanes, stream)
    _lanes_ok(lanes, ne, "cgr_residual")
    if zeta_k < 1:
        raise ValueError(f"zeta_k must be at least 1, not {zeta_k}")
    if dev.type == "cpu":
        return cgr_residual_plain(stream, *lanes, ne, zeta_k)
    if tiles is None or order is None:
        tables = residual_tables(counts)
        tiles, order = tables["tiles"], tables["order"]
    if (tiles.dim() != 1 or tiles.numel() < 1 or order.dim() != 1
            or order.numel() != data_p.numel()
            or any(t.dtype != torch.int32 or not t.is_contiguous()
                   or t.device != dev for t in (tiles, order))):
        raise ValueError("cgr_residual: tiles (n_tiles + 1,) and order (L,) "
                         "must be contiguous int32 on the stream's device")
    lib = _build.load_library("cgr_decode")
    col = torch.empty(ne, dtype=torch.int32, device=dev)
    pfin = torch.empty_like(data_p)
    rc = lib.gab_cgr_residual(stream.data_ptr(), _nwords(stream),
                              *(t.data_ptr() for t in lanes), data_p.numel(),
                              tiles.data_ptr(), tiles.numel() - 1,
                              order.data_ptr(), zeta_k, col.data_ptr(), ne,
                              pfin.data_ptr(), *_launch_tail(stream))
    _raise_on(rc, lib, "cgr_residual", f"{data_p.numel()} lanes")
    LAUNCHES["cgr_residual"] += 1
    return col, pfin


def cgr_interval(stream, data_p, counts, lane_v, base, n_itv: int,
                 min_itv_len: int):
    """(left, len) (n_itv,) int32 and each lane's final bit (L,) int32."""
    lanes = (data_p, counts, lane_v, base)
    dev = _check(lanes, stream)
    _lanes_ok(lanes, n_itv, "cgr_interval")
    if dev.type == "cpu":
        return cgr_interval_plain(stream, *lanes, n_itv, min_itv_len)
    lib = _build.load_library("cgr_decode")
    left = torch.empty(n_itv, dtype=torch.int32, device=dev)
    length = torch.empty(n_itv, dtype=torch.int32, device=dev)
    pfin = torch.empty_like(data_p)
    rc = lib.gab_cgr_interval(stream.data_ptr(), _nwords(stream),
                              *(t.data_ptr() for t in lanes), data_p.numel(),
                              min_itv_len, left.data_ptr(), length.data_ptr(),
                              pfin.data_ptr(), *_launch_tail(stream))
    _raise_on(rc, lib, "cgr_interval", f"{data_p.numel()} lanes")
    LAUNCHES["cgr_interval"] += 1
    return left, length, pfin


def merge_tile_rows(row_ptr: torch.Tensor, ne: int,
                    tile_slots: int = MERGE_TILE_SLOTS) -> torch.Tensor:
    """``cgr_merge``'s tile table, on ``row_ptr``'s device: the row that
    holds each tile's first slot (the last row whose pointer is at most
    the slot), then the last row; ceil(ne / tile_slots) + 1 int32."""
    nv = row_ptr.numel() - 1
    starts = torch.arange(0, ne, tile_slots, dtype=row_ptr.dtype,
                          device=row_ptr.device)
    rows = torch.searchsorted(row_ptr, starts, right=True) - 1
    return torch.cat([rows, rows.new_full((1,), max(nv - 1, 0))]).to(
        torch.int32)


def cgr_merge(res, row_ptr, nres, itv_ptr, left, length, itv_pre, *,
              tile_row=None):
    """The rows' residual runs of ``res`` merged with their intervals into a
    new (ne,) int32 ``col``: ``row_ptr`` (nv + 1,), ``nres`` (nv,),
    ``itv_ptr`` (nv + 1,) the rows' intervals, ``left`` and ``length``
    (n_itv,), ``itv_pre`` (n_itv + 1,) the prefix of the lengths; a row's
    slots hold its residuals and its intervals' ids, as the prep builds
    them. ``tile_row``: the kernel's tile table (``merge_tile_rows``, built
    on the card when it is not given); the plain version takes none."""
    nv = nres.numel()
    dev = res.device
    args = (res, row_ptr, nres, itv_ptr, left, length, itv_pre)
    for t in args:
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError("cgr_merge: operands must be contiguous 1-D "
                             "int32 on one device")
    if (row_ptr.numel() != nv + 1 or itv_ptr.numel() != nv + 1
            or left.numel() != length.numel()
            or itv_pre.numel() != left.numel() + 1):
        raise ValueError("cgr_merge: inconsistent shapes")
    if dev.type == "cpu":
        return cgr_merge_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"cgr_merge runs on cpu or cuda, not {dev}")
    ne = res.numel()
    if tile_row is None:
        tile_row = merge_tile_rows(row_ptr, ne)
    n_tiles = -(-ne // MERGE_TILE_SLOTS)
    if (tile_row.dtype != torch.int32 or tile_row.dim() != 1
            or not tile_row.is_contiguous() or tile_row.device != dev
            or tile_row.numel() != n_tiles + 1):
        raise ValueError(f"cgr_merge: tile_row must be {n_tiles + 1} "
                         f"contiguous int32 on the operands' device")
    lib = _build.load_library("cgr_decode")
    col = torch.empty_like(res)
    rc = lib.gab_cgr_merge(*(t.data_ptr() for t in args), nv,
                           tile_row.data_ptr(), n_tiles, MERGE_TILE_SLOTS, ne,
                           col.data_ptr(), *_launch_tail(res))
    _raise_on(rc, lib, "cgr_merge", f"{nv} rows")
    LAUNCHES["cgr_merge"] += 1
    return col
