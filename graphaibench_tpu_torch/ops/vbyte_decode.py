"""The byte codecs' decode passes: the hand-written CUDA kernels K11
(``csrc/vbyte_decode.cu``) with their plain PyTorch versions.

Counterpart of the XLA programs of
``graphaibench_tpu/compress/device_decode.py`` (``streamvbyte_decode_device``,
``_vgb_tag_chain``, ``_vgb_flat_values``). The stream is a uint8 tensor
(``ops/cgr_decode.py::stream_tensor``, the same upload as CGR's); every pass
works on rows given by int32 arrays:

- ``svb_decode``: a StreamVByte row of ``counts[r]`` ids whose key bytes start
  at byte ``key_start[r]`` (the values follow the ``ceil(count / 4)`` key
  bytes) writes its ids at ``col[out_slot[r] + i]``: each value's length from
  its 2-bit code, its byte offset by an exclusive prefix of the lengths, 1 to 4
  bytes little-endian, the ids by an inclusive prefix of the gaps. The kernel
  takes two tables (``svb_tables``): the rows of more than
  ``SVB_LONG_VALUES`` values, widest first, a block each, and tiles of the
  other rows, runs of consecutive rows a warp decodes together.
- ``vgb_tags``: a VarintGB row of ``ngroups[r]`` groups whose first tag is at
  byte ``pos[r]`` writes each group's tag position at ``tagpos[gbase[r] + j]``,
  the next tag ``5 + (the tag's four codes)`` bytes on (``VGB_GLEN``). The
  kernel takes two tables (``vgb_tag_tables``): the rows of more than
  ``VGB_LONG_GROUPS`` groups, widest first, each cut into chunks across a
  block, and tiles of the other rows, runs of consecutive rows whose bytes
  a block stages at once.
- ``vgb_values``: a VarintGB row of ``counts[r]`` ids in the groups
  ``gbase[r] ..`` reads each group's tag and four values (a prefix within the
  group), a prefix of the group sums across the row, and writes the row's ids
  at ``col[out_slot[r] + i]``; the padding of the last group is dropped. The
  kernel takes two tables (``vgb_value_tables``): the rows of more than
  ``VGB_LONG_GROUPS`` groups, widest first, a block each, and tiles of the
  other rows, runs of consecutive rows whose groups a block decodes flat.

The arithmetic is the same in both versions, garbage included: byte reads
clamped to the stream, sums modulo 2^32 stored as int32, a slot outside the
output not written, a group index outside ``tagpos`` read as position 0. Each
wrapper takes the plain version for tensors on the CPU and launches its
kernel, once, for tensors on a CUDA device, or raises; ``LAUNCHES`` counts the
launches. ``svb_decode`` and ``vgb_values`` write into the ``col`` they are
given and return it; the slots no row covers keep what they held.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops._ell_launch import _launch_tail, _raise_on

LAUNCHES = {"svb_decode": 0, "vgb_tags": 0, "vgb_values": 0}

# a VarintGB group's byte length from its tag alone: the tag byte and the
# four values' (code + 1) bytes
VGB_GLEN = np.array(
    [5 + sum((t >> (2 * k)) & 3 for k in range(4)) for t in range(256)],
    dtype=np.int32)
# vgb_tags' tables: a row of more than VGB_LONG_GROUPS groups is long (a
# block of its own); a tile holds the other rows of VGB_TILE_BYTES of the
# stream (from the prep's byte offsets) or VGB_TILE_ROWS rows (without
# them), so that its bytes fit the kernel's staged window (kWinBytes,
# 15,872: VGB_TILE_BYTES plus a short row's most, 17 * 256 + 4) and its
# tags its collected ones (kOutSlots, 3,200)
VGB_LONG_GROUPS = 256
# svb_decode's tables: a row of more than SVB_LONG_VALUES values is long (a
# block of its own, staged 512 quads at a time); a tile (a warp's, in rounds of
# 64 quads) is a run of rows whose first quads (a quad: the up to four
# values of one key byte) lie in one window of SVB_TILE_QUADS quads and
# whose indices in one window of SVB_TILE_ROWS rows, so that it mostly
# fills about two rounds and never passes a batch of the warp's 32 rows
SVB_LONG_VALUES = 1024
SVB_TILE_QUADS = 112
SVB_TILE_ROWS = 32
VGB_TILE_BYTES = 11264
VGB_TILE_ROWS = 256
# vgb_values' tables: a tile ends where its rows' first groups (counted over
# the rows of 1 to VGB_LONG_GROUPS groups) cross a multiple of
# VGB_VALUE_TILE_GROUPS, the rows' indices one of VGB_VALUE_TILE_ROWS (the
# kernel's threads), and at every long row, so that its groups fit the
# kernel's kValGroups (1,024: VGB_VALUE_TILE_GROUPS plus a short row's most)
VGB_VALUE_TILE_GROUPS = 768
VGB_VALUE_TILE_ROWS = 256


def _check(stream: torch.Tensor, rows, outs) -> torch.device:
    dev = stream.device
    if (stream.dtype != torch.uint8 or stream.dim() != 1
            or stream.numel() < 1 or not stream.is_contiguous()):
        raise ValueError("the stream must be a non-empty contiguous 1-D uint8 "
                         "tensor (stream_tensor)")
    for t in (*rows, *outs):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError("row arrays and outputs must be contiguous 1-D "
                             "int32 on the stream's device")
    if any(t.numel() != rows[0].numel() for t in rows):
        raise ValueError("row arrays of different lengths")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the K11 passes run on cpu or cuda, not {dev}")
    return dev


# ---- plain PyTorch versions ------------------------------------------------

def _byte(stream: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """The stream's bytes at int64 positions ``i``, clamped to it, as int64."""
    return stream[i.clamp(0, stream.numel() - 1)].long()


def _read_le(stream, o, length):
    """The little-endian value of ``length`` (0..4) bytes at ``o``, int64."""
    v = torch.zeros_like(o)
    for k in range(4):
        v |= torch.where(length > k, _byte(stream, o + k), 0) << (8 * k)
    return v


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 by its low 32 bits."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _items(n: torch.Tensor):
    """(the row of every item, its index in the row, the row's first item)
    for rows of ``n`` (int64, clamped at 0) items, in row order."""
    n = n.clamp(min=0)
    total = int(n.sum())
    row = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n,
                                  output_size=total)
    first = torch.cumsum(n, 0) - n
    return row, torch.arange(total, device=n.device) - first[row], first


def _in_row_prefix(x, row, first, inclusive: bool):
    """The prefix of ``x`` (int64) within each row, over items in row
    order."""
    c = torch.cumsum(x, 0)
    return (c if inclusive else c - x) - (c - x)[first[row]]


def _store(col, slot, vals, keep=None):
    """col[slot] = vals where ``keep`` and the slot lies inside ``col``."""
    inside = (slot >= 0) & (slot < col.numel())
    keep = inside if keep is None else keep & inside
    col[slot[keep]] = _wrap32(vals[keep])
    return col


def svb_decode_plain(stream, key_start, counts, out_slot, col):
    n = counts.long()
    row, i, first = _items(n)
    ks = key_start.long()[row]
    code = (_byte(stream, ks + (i >> 2)) >> ((i & 3) * 2)) & 3
    length = code + 1
    data = ks + ((n[row] + 3) >> 2)
    o = data + _in_row_prefix(length, row, first, inclusive=False)
    gaps = _read_le(stream, o, length)
    ids = _in_row_prefix(gaps, row, first, inclusive=True)
    return _store(col, out_slot.long()[row] + i, ids)


def vgb_tags_plain(stream, pos, ngroups, gbase, n_g: int):
    tagpos = torch.zeros(n_g, dtype=torch.int32, device=stream.device)
    ng = ngroups.long()
    order = torch.argsort(ng, descending=True, stable=True)
    ng = ng[order]
    p = pos.long()[order]
    g0 = gbase.long()[order]
    glen = torch.from_numpy(VGB_GLEN).long().to(stream.device)
    steps = int(ng[0]) if ng.numel() else 0
    for j in range(steps):
        n = int((ng > j).sum())
        slot = g0[:n] + j
        ok = (slot >= 0) & (slot < n_g)
        tagpos[slot[ok]] = _wrap32(p[:n][ok])
        p[:n] += glen[_byte(stream, p[:n])]
    return tagpos


def vgb_values_plain(stream, tagpos, gbase, counts, out_slot, col):
    n = counts.long()
    grow, j, gfirst = _items((n + 3) >> 2)
    gi = gbase.long()[grow] + j
    o = torch.zeros_like(gi)
    if tagpos.numel():
        inside = (gi >= 0) & (gi < tagpos.numel())
        o = torch.where(inside, tagpos.long()[gi.clamp(0, tagpos.numel() - 1)],
                        0)
    tag = _byte(stream, o)
    o = o + 1
    within = []
    acc = torch.zeros_like(o)
    for k in range(4):
        length = ((tag >> (2 * k)) & 3) + 1
        acc = acc + _read_le(stream, o, length)
        o = o + length
        within.append(acc)
    within = torch.stack(within, 1)                         # (G, 4)
    base = _in_row_prefix(within[:, 3], grow, gfirst, inclusive=False)
    e = 4 * j[:, None] + torch.arange(4, device=o.device)[None, :]
    slot = out_slot.long()[grow][:, None] + e
    return _store(col, slot.reshape(-1), (base[:, None] + within).reshape(-1),
                  (e < n[grow][:, None]).reshape(-1))


# ---- the kernels' wrappers -------------------------------------------------

def svb_tables(counts: torch.Tensor) -> dict:
    """``svb_decode``'s tables for rows of ``counts`` values (int32, on any
    device; the tables on the same one): ``long_rows``, the rows of more
    than SVB_LONG_VALUES values, widest first, and ``tiles`` (n_tiles + 1,),
    each tile's first row and then the end: a tile ends where the rows'
    first quads (counted over the other rows with values) cross a multiple
    of SVB_TILE_QUADS or the rows' indices one of SVB_TILE_ROWS. int32."""
    n = counts.long()
    long = n > SVB_LONG_VALUES
    q = torch.where(long | (n <= 0), 0, (n + 3) >> 2)
    first = torch.cumsum(q, 0) - q
    key = (first // SVB_TILE_QUADS
           + torch.arange(n.numel(), device=n.device) // SVB_TILE_ROWS)
    cut = torch.nonzero(key.diff()).flatten() + 1
    tiles = torch.cat([cut.new_zeros(1), cut, cut.new_full((1,), n.numel())])
    rows = torch.nonzero(long).flatten()
    rows = rows[torch.argsort(n[rows], descending=True, stable=True)]
    return {"long_rows": rows.to(torch.int32),
            "tiles": tiles.clamp(max=2**31 - 1).to(torch.int32)}


def svb_decode(stream, key_start, counts, out_slot, col, *, long_rows=None,
               tiles=None):
    """``col`` with every row's ids written at ``col[out_slot[r] + i]``.
    ``long_rows`` and ``tiles``: the kernel's tables (``svb_tables``, which
    builds them on the card when they are not given); the plain version
    takes none."""
    dev = _check(stream, (key_start, counts, out_slot), (col,))
    if dev.type == "cpu":
        return svb_decode_plain(stream, key_start, counts, out_slot, col)
    if long_rows is None or tiles is None:
        tables = svb_tables(counts)
        long_rows, tiles = tables["long_rows"], tables["tiles"]
    if (long_rows.dim() != 1 or tiles.dim() != 1 or tiles.numel() < 1
            or any(t.dtype != torch.int32 or not t.is_contiguous()
                   or t.device != dev for t in (long_rows, tiles))):
        raise ValueError("svb_decode: long_rows (n,) and tiles (n_tiles + 1,) "
                         "must be contiguous int32 on the stream's device")
    lib = _build.load_library("vbyte_decode")
    rc = lib.gab_svb_decode(stream.data_ptr(), stream.numel(),
                            key_start.data_ptr(), counts.data_ptr(),
                            out_slot.data_ptr(), key_start.numel(),
                            long_rows.data_ptr(), long_rows.numel(),
                            tiles.data_ptr(), tiles.numel() - 1,
                            SVB_LONG_VALUES, col.data_ptr(), col.numel(),
                            *_launch_tail(stream))
    _raise_on(rc, lib, "svb_decode", f"{key_start.numel()} rows")
    LAUNCHES["svb_decode"] += 1
    return col


def vgb_tag_tables(ngroups, pos, gbase, bounds=None) -> dict:
    """``vgb_tags``' tables for rows of ``ngroups`` groups, the first tag at
    byte ``pos``, the first slot ``gbase``: ``long_rows``, the rows of more
    than VGB_LONG_GROUPS groups, widest first, and ``tiles``, (n_tiles + 1,
    5): each tile's first row, the first byte and the bytes to stage (from
    the first tag of its other rows to the farthest they reach), the first
    slot and the slots to collect; the last row holds the end. With
    ``bounds`` (the rows' byte boundaries, nv + 1, as the prep has them
    from the offsets) from numpy arrays: tiles cut where the stream
    crosses a multiple of VGB_TILE_BYTES and at every long row (which then
    begins its tile and is skipped there), a row reaching to the next
    one's start; without, from tensors, on their device: tiles of
    VGB_TILE_ROWS rows, a row reaching 17 bytes a group. int32, on the
    device of ``ngroups`` (the host's for numpy)."""
    if bounds is not None:
        bounds = np.asarray(bounds, np.int64)
        long = np.asarray(ngroups) > VGB_LONG_GROUPS
        key = bounds[:-1] // VGB_TILE_BYTES + np.cumsum(long)
        cut = np.flatnonzero(np.diff(key)) + 1
        tile_ptr = torch.from_numpy(np.r_[0, cut, len(long)])
        ng, p, g, end = (torch.from_numpy(np.asarray(a, np.int64))
                         for a in (ngroups, pos, gbase, bounds[1:]))
    else:
        ng, p, g = ngroups.long(), pos.long(), gbase.long()
        tile_ptr = torch.arange(0, ng.numel() + VGB_TILE_ROWS, VGB_TILE_ROWS,
                                device=ng.device).clamp(max=ng.numel())
        end = p + 17 * ng
    dev = ng.device
    rows = torch.nonzero(ng > VGB_LONG_GROUPS).flatten()
    rows = rows[torch.argsort(ng[rows], descending=True, stable=True)]
    n_tiles = tile_ptr.numel() - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                   tile_ptr.diff(), output_size=ng.numel())
    short = (ng > 0) & (ng <= VGB_LONG_GROUPS)

    def per_tile(x, how):
        """The min or max of x over each tile's short rows (0 without)."""
        return torch.zeros(n_tiles, dtype=torch.long, device=dev).scatter_reduce(
            0, tile[short], x[short], how, include_self=False)

    b_lo, g_lo = per_tile(p, "amin"), per_tile(g, "amin")
    tiles = torch.zeros((n_tiles + 1, 5), dtype=torch.long, device=dev)
    tiles[:, 0] = tile_ptr
    tiles[:-1, 1] = b_lo
    tiles[:-1, 2] = (per_tile(end, "amax") - b_lo).clamp(0, 2**31 - 1)
    tiles[:-1, 3] = g_lo
    tiles[:-1, 4] = (per_tile(g + ng, "amax") - g_lo).clamp(0, 2**31 - 1)
    return {"long_rows": rows.to(torch.int32),
            "tiles": tiles.clamp(-2**31, 2**31 - 1).to(torch.int32)}


def vgb_tags(stream, pos, ngroups, gbase, n_g: int, *, long_rows=None,
             tiles=None):
    """(n_g,) int32: the byte of every group's tag, row r's at
    ``gbase[r] ..``; slots no row covers are undefined on the card (0 in the
    plain version). ``long_rows`` and ``tiles``: the kernel's tables
    (``vgb_tag_tables``, which builds them on the card when they are not
    given); the plain version takes none."""
    dev = _check(stream, (pos, ngroups, gbase), ())
    if n_g >= 2**31:
        raise ValueError("vgb_tags: group count past int32")
    if dev.type == "cpu":
        return vgb_tags_plain(stream, pos, ngroups, gbase, n_g)
    if long_rows is None or tiles is None:
        tables = vgb_tag_tables(ngroups, pos, gbase)
        long_rows, tiles = tables["long_rows"], tables["tiles"]
    if (long_rows.dim() != 1 or tiles.dim() != 2 or tiles.shape[1] != 5
            or tiles.shape[0] < 1
            or any(t.dtype != torch.int32 or not t.is_contiguous()
                   or t.device != dev for t in (long_rows, tiles))):
        raise ValueError("vgb_tags: long_rows (n,) and tiles (n_tiles + 1, "
                         "5) must be contiguous int32 on the stream's device")
    lib = _build.load_library("vbyte_decode")
    tagpos = torch.empty(n_g, dtype=torch.int32, device=dev)
    rc = lib.gab_vgb_tags(stream.data_ptr(), stream.numel(), pos.data_ptr(),
                          ngroups.data_ptr(), gbase.data_ptr(), pos.numel(),
                          long_rows.data_ptr(), long_rows.numel(),
                          tiles.data_ptr(), tiles.shape[0] - 1,
                          VGB_LONG_GROUPS, tagpos.data_ptr(), n_g,
                          *_launch_tail(stream))
    _raise_on(rc, lib, "vgb_tags", f"{pos.numel()} rows")
    LAUNCHES["vgb_tags"] += 1
    return tagpos


def vgb_value_tables(gbase, counts, out_slot) -> dict:
    """``vgb_values``' tables for rows of ``counts`` ids in the groups from
    ``gbase``, the ids from slot ``out_slot`` (int32, on any device; the
    tables on the same one): ``long_rows``, the rows of more than
    VGB_LONG_GROUPS groups, widest first, and ``tiles``, (n_tiles + 1, 4):
    each tile's first row, first group, groups to stage and first slot
    (over its rows of 1 to VGB_LONG_GROUPS groups: from the least first
    group to the farthest last, the least first slot; 0 without such
    rows); the last row holds the end. A tile ends where those rows' first
    groups, counted over them, cross a multiple of VGB_VALUE_TILE_GROUPS,
    where the rows' indices cross one of VGB_VALUE_TILE_ROWS, and at every
    long row, which begins its tile and is skipped there. int32."""
    n = counts.long().clamp(min=0)
    ng = (n + 3) >> 2
    dev = ng.device
    g = gbase.long()
    long = ng > VGB_LONG_GROUPS
    short = (ng > 0) & ~long
    q = torch.where(short, ng, 0)
    key = ((torch.cumsum(q, 0) - q) // VGB_VALUE_TILE_GROUPS
           + torch.arange(ng.numel(), device=dev) // VGB_VALUE_TILE_ROWS
           + torch.cumsum(long.long(), 0))
    cut = torch.nonzero(key.diff()).flatten() + 1
    tile_ptr = torch.cat([cut.new_zeros(1), cut,
                          cut.new_full((1,), ng.numel())])
    n_tiles = tile_ptr.numel() - 1
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                   tile_ptr.diff(), output_size=ng.numel())

    def per_tile(x, how):
        """The min or max of x over each tile's short rows (0 without)."""
        return torch.zeros(n_tiles, dtype=torch.long, device=dev).scatter_reduce(
            0, tile[short], x.long()[short], how, include_self=False)

    tiles = torch.zeros((n_tiles + 1, 4), dtype=torch.long, device=dev)
    tiles[:, 0] = tile_ptr
    g_lo = per_tile(g, "amin")
    tiles[:-1, 1] = g_lo
    tiles[:-1, 2] = (per_tile(g + ng, "amax") - g_lo).clamp(0, 2**31 - 1)
    tiles[:-1, 3] = per_tile(out_slot, "amin")
    rows = torch.nonzero(long).flatten()
    rows = rows[torch.argsort(ng[rows], descending=True, stable=True)]
    return {"long_rows": rows.to(torch.int32),
            "tiles": tiles.clamp(-2**31, 2**31 - 1).to(torch.int32)}


def vgb_values(stream, tagpos, gbase, counts, out_slot, col, *,
               long_rows=None, tiles=None):
    """``col`` with every row's ids written at ``col[out_slot[r] + i]``.
    ``long_rows`` and ``tiles``: the kernel's tables (``vgb_value_tables``,
    which builds them on the card when they are not given); the plain
    version takes none."""
    dev = _check(stream, (gbase, counts, out_slot), (tagpos, col))
    if dev.type == "cpu":
        return vgb_values_plain(stream, tagpos, gbase, counts, out_slot, col)
    if long_rows is None or tiles is None:
        tables = vgb_value_tables(gbase, counts, out_slot)
        long_rows, tiles = tables["long_rows"], tables["tiles"]
    if (long_rows.dim() != 1 or tiles.dim() != 2 or tiles.shape[1] != 4
            or tiles.shape[0] < 1
            or any(t.dtype != torch.int32 or not t.is_contiguous()
                   or t.device != dev for t in (long_rows, tiles))):
        raise ValueError("vgb_values: long_rows (n,) and tiles (n_tiles + 1, "
                         "4) must be contiguous int32 on the stream's device")
    lib = _build.load_library("vbyte_decode")
    rc = lib.gab_vgb_values(stream.data_ptr(), stream.numel(),
                            tagpos.data_ptr(), tagpos.numel(),
                            gbase.data_ptr(), counts.data_ptr(),
                            out_slot.data_ptr(), gbase.numel(),
                            long_rows.data_ptr(), long_rows.numel(),
                            tiles.data_ptr(), tiles.shape[0] - 1,
                            VGB_LONG_GROUPS, col.data_ptr(), col.numel(),
                            *_launch_tail(stream))
    _raise_on(rc, lib, "vgb_values", f"{gbase.numel()} rows")
    LAUNCHES["vgb_values"] += 1
    return col
