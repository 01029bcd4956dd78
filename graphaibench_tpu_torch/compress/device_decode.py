"""StreamVByte, VarintGB and hybrid adjacency decoding on the device,
through the kernels K11 (``ops/vbyte_decode.py``, ``csrc/vbyte_decode.cu``)
and, for hybrid's low-degree rows, K12's ``cgr_residual``.

Counterpart of ``graphaibench_tpu/compress/device_decode.py``, with its
names. The stream's bytes go to the device once (``K12.stream_tensor``, the
upload CGR takes); the degrees come from ``.degree.bin``, so a StreamVByte
row's count word is skipped, not parsed. Each decode is a prep, the host
work (the degrees' checks and prefix sums, the rows' byte positions, the
uploads), and a run, the kernels alone:

- StreamVByte: one ``svb_decode`` launch, a row's key bytes at its word
  offset times 4, plus 4 for the count word (its tables, the long rows and
  the tiles, built by the prep);
- VarintGB: ``vgb_tags`` walks each row's tag chain from byte ``offset * 4 +
  4`` into the groups' tag positions (its tables, the long rows and the
  tiles cut at the rows' byte offsets, built by the prep), then
  ``vgb_values`` decodes every group given its tag (its tables, the long
  rows and the tiles of consecutive rows, built by the prep); the chain is
  serial within a row, so its two passes are the counterpart of JAX's
  ``_vgb_tag_chain`` and ``_vgb_flat_values``;
- hybrid: the rows of degree below the threshold are unsegmented zeta_k
  streams after a gamma degree, one ``cgr_residual`` lane a row from the bit
  after that gamma (its length computed on the host from the degree; its
  tables, the tiles of consecutive low rows, built by the prep); the
  other rows are count-word-free StreamVByte chunks at their byte offsets,
  one ``svb_decode`` launch writing into the same ``col`` at their row
  pointers (its tables built by the prep over those rows).

JAX's ``lax.scan`` trip grids (``_VGB_TRIP_GRID``, hybrid's ``grid``) are not
carried: the kernels loop over each row's own count, so a VarintGB hub past
``4 * _VGB_SUBS * 4096`` values and a hybrid hub of degree 2,500 under
threshold 3,000, which JAX refuses, decode here.

Refused with ``StreamRefused`` by the prep, before any launch: degrees that
do not sum to ``ne`` or a negative one, a row's first byte past the padded
stream, byte positions past int32 (for hybrid, bit positions: K12's
``data_p`` is int32), and a hybrid whose chunks are VarintGB (JAX decodes
those on the host too). The caller may then decode on the host. Any other
fault raises as it is: a wrapper's ``ValueError`` for its operands, a
kernel's ``RuntimeError``.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.compress.cgr_device import (
    StreamRefused, int32_on, residual_tables_on)
from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.ops import cgr_decode as K12
from graphaibench_tpu_torch.ops import vbyte_decode as K11


def _degrees(degrees, nv: int, ne: int, what: str):
    """(degrees int64, row_ptr int64) of a stream whose degrees must be
    non-negative and sum to ``ne``, with every slot an int32."""
    deg = np.asarray(degrees, dtype=np.int64)
    if len(deg) != nv or (deg < 0).any() or int(deg.sum()) != ne:
        raise StreamRefused(f"device {what} decode: degrees that are not "
                            f"{nv} non-negative counts summing to {ne}")
    if ne >= 2**31:
        raise StreamRefused(f"device {what} decode: {ne} edges, past int32 "
                            f"slots")
    return deg, np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)


def _check_positions(data: bytes, starts: np.ndarray, what: str,
                     bits: bool = False) -> None:
    """StreamRefused unless every position in the padded stream fits int32
    (its bit positions with ``bits``) and every row's first byte ``starts``
    lies inside it."""
    padded = len(data) + (-len(data)) % 4 + K12.PAD_BYTES
    if padded * (8 if bits else 1) >= 2**31:
        raise StreamRefused(f"device {what} decode: stream too large for "
                            f"int32 {'bit' if bits else 'byte'} positions")
    if len(starts) and (starts.min() < 0 or starts.max() >= padded):
        raise StreamRefused(f"device {what} decode: offsets past the padded "
                            f"stream")


# ---- StreamVByte -----------------------------------------------------------

def streamvbyte_decode_device(stream: torch.Tensor, word_offsets: torch.Tensor,
                              degrees: torch.Tensor, *, nv: int, ne: int,
                              count_word: bool = True):
    """Decode every adjacency list of a StreamVByte stream on its device.

    ``stream``: the bytes (``K12.stream_tensor``); ``word_offsets``: (nv + 1,)
    int32 per-row word offsets (byte offsets with ``count_word=False``, as in
    hybrid's chunks, which have no count word); ``degrees``: (nv,) int32.
    Returns (row_ptr (nv + 1,), col_idx (ne,)) int32 on the stream's device:
    one ``svb_decode`` launch."""
    dev = stream.device
    row_ptr = torch.zeros(nv + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(degrees, 0, dtype=torch.int32)
    col = torch.empty(ne, dtype=torch.int32, device=dev)
    if ne == 0:
        return row_ptr, col
    key_start = (word_offsets[:nv] * 4 + 4 if count_word
                 else word_offsets[:nv].contiguous())
    K11.svb_decode(stream, key_start, degrees, row_ptr[:nv], col)
    return row_ptr, col


def streamvbyte_device_prep(vg, *, device="cuda") -> dict:
    """The host work of the StreamVByte decode: the checks, the stream and
    the row tables on ``device``."""
    if vg.scheme != "streamvbyte":
        raise ValueError(f"expected streamvbyte, got {vg.scheme!r}")
    deg, row_ptr = _degrees(vg.degrees, vg.nv, vg.ne, "streamvbyte")
    off = np.asarray(vg.offsets, dtype=np.int64)
    _check_positions(vg.data, off[:vg.nv][deg > 0] * 4 + 4, "streamvbyte")
    return {"stream": K12.stream_tensor(vg.data, device),
            "word_offsets": int32_on(off, device),
            "key_start": int32_on(off[:vg.nv] * 4 + 4, device),
            "out_slot": int32_on(row_ptr[:vg.nv], device),
            "degrees": int32_on(deg, device), "row_ptr": row_ptr,
            "svb_tables": _svb_tables(deg, device),
            "nv": vg.nv, "ne": vg.ne, "device": device}


def _svb_tables(counts: np.ndarray, device) -> dict:
    """``svb_decode``'s tables for rows of ``counts`` values, built on the
    host and uploaded."""
    return {k: t.to(device) for k, t in K11.svb_tables(
        torch.from_numpy(np.asarray(counts, np.int32))).items()}


def streamvbyte_device_run(prep: dict) -> torch.Tensor:
    """The decode proper, given a prep: the (ne,) int32 col_idx on the
    device, one ``svb_decode`` launch under the prep's tables."""
    col = torch.empty(prep["ne"], dtype=torch.int32, device=prep["device"])
    if prep["ne"] == 0:
        return col
    return K11.svb_decode(prep["stream"], prep["key_start"], prep["degrees"],
                          prep["out_slot"], col, **prep["svb_tables"])


def decode_graph_device(vg, *, device="cuda") -> CSRGraph:
    """Decode a StreamVByte or VarintGB graph on ``device`` into a host
    CSRGraph (for the analytics solvers)."""
    if vg.scheme == "varintgb":
        return varintgb_decode_device(vg, device=device)
    if vg.scheme != "streamvbyte":
        raise ValueError(
            f"device decode supports streamvbyte/varintgb, not "
            f"{vg.scheme!r} (CGR goes through compress.cgr_device)")
    prep = streamvbyte_device_prep(vg, device=device)
    col = streamvbyte_device_run(prep)
    return CSRGraph(row_ptr=prep["row_ptr"], col_idx=col.cpu().numpy())


# ---- VarintGB --------------------------------------------------------------

def varintgb_device_prep(vg, *, device="cuda") -> dict:
    """The host work of the VarintGB decode: the checks, the stream and the
    row tables (first tag byte, group count, first group, degree, first
    slot) on ``device``, so that ``varintgb_device_run`` does no host
    work."""
    if vg.scheme != "varintgb":
        raise ValueError(f"expected varintgb, got {vg.scheme!r}")
    nv, ne = vg.nv, vg.ne
    deg, row_ptr = _degrees(vg.degrees, nv, ne, "varintgb")
    ngroups = (deg + 3) // 4
    group_ptr = np.concatenate([[0], np.cumsum(ngroups)]).astype(np.int64)
    # +4 skips each row's count word (offsets count words)
    bounds = np.asarray(vg.offsets, dtype=np.int64)[:nv + 1] * 4
    pos = np.where(deg > 0, bounds[:nv] + 4, 0)
    _check_positions(vg.data, pos[deg > 0], "varintgb")
    tables = K11.vgb_tag_tables(ngroups, pos, group_ptr[:nv], bounds)
    values = K11.vgb_value_tables(*(torch.from_numpy(a) for a in (
        group_ptr[:nv], deg, row_ptr[:nv])))
    return {"stream": K12.stream_tensor(vg.data, device),
            "tag_tables": {k: t.to(device) for k, t in tables.items()},
            "value_tables": {k: t.to(device) for k, t in values.items()},
            "pos": int32_on(pos, device), "ngroups": int32_on(ngroups, device),
            "gbase": int32_on(group_ptr[:nv], device),
            "counts": int32_on(deg, device),
            "out_slot": int32_on(row_ptr[:nv], device), "row_ptr": row_ptr,
            "nv": nv, "ne": ne, "n_g": int(group_ptr[-1]), "device": device}


def varintgb_device_run(prep: dict) -> torch.Tensor:
    """The decode proper, given a prep: ``vgb_tags`` then ``vgb_values``, no
    host work. Returns the (ne,) int32 col_idx on the device."""
    col = torch.empty(prep["ne"], dtype=torch.int32, device=prep["device"])
    if prep["ne"] == 0:
        return col
    tagpos = K11.vgb_tags(prep["stream"], prep["pos"], prep["ngroups"],
                          prep["gbase"], prep["n_g"], **prep["tag_tables"])
    return K11.vgb_values(prep["stream"], tagpos, prep["gbase"],
                          prep["counts"], prep["out_slot"], col,
                          **prep["value_tables"])


def varintgb_decode_device(vg, *, device="cuda") -> CSRGraph:
    """Decode a VarintGB graph on ``device`` (prep and run) into a host
    CSRGraph."""
    prep = varintgb_device_prep(vg, device=device)
    col = varintgb_device_run(prep)
    return CSRGraph(row_ptr=prep["row_ptr"], col_idx=col.cpu().numpy())


# ---- hybrid ----------------------------------------------------------------

def _gamma_len(x: np.ndarray) -> np.ndarray:
    """Elias gamma's bit length of each x >= 0: 2 floor(log2(x + 1)) + 1."""
    y = np.asarray(x, dtype=np.int64) + 1
    h = np.zeros_like(y)
    for s in (32, 16, 8, 4, 2, 1):
        big = y >= (np.int64(1) << s)
        h += np.where(big, s, 0)
        y = np.where(big, y >> s, y)
    return 2 * h + 1


def hybrid_device_prep(hg, *, device="cuda") -> dict:
    """The host work of the hybrid decode: the checks, the stream, the
    low-degree rows' ``cgr_residual`` lanes and the high-degree rows'
    ``svb_decode`` rows on ``device``."""
    if hg.vbyte_scheme != "streamvbyte":
        raise StreamRefused(f"device hybrid decode: {hg.vbyte_scheme} chunks "
                            f"(the device decode takes streamvbyte chunks)")
    nv, ne = hg.nv, hg.ne
    deg, row_ptr = _degrees(hg.degrees, nv, ne, "hybrid")
    off = np.asarray(hg.offsets, dtype=np.int64)       # byte offsets
    low = np.nonzero((deg > 0) & (deg < hg.threshold))[0]
    high = np.nonzero((deg > 0) & (deg >= hg.threshold))[0]
    _check_positions(hg.data, off[np.r_[low, high]], "hybrid", bits=True)
    counts = deg[low]
    low_lanes = (off[low] * 8 + _gamma_len(counts), counts, low, row_ptr[low])
    return {"stream": K12.stream_tensor(hg.data, device), "nv": nv, "ne": ne,
            "zeta_k": hg.zeta_k, "row_ptr": row_ptr, "device": device,
            "low": tuple(int32_on(a, device) for a in low_lanes),
            "high": tuple(int32_on(a, device) for a in (
                off[high], deg[high], row_ptr[high])),
            "svb_tables": _svb_tables(deg[high], device),
            "res_tables": residual_tables_on(counts, device)}


def hybrid_device_run(prep: dict) -> torch.Tensor:
    """The decode proper, given a prep: one ``cgr_residual`` launch over the
    low-degree rows, one ``svb_decode`` over the high-degree rows into the
    same ``col``. Returns the (ne,) int32 col_idx on the device."""
    ne = prep["ne"]
    low, high = prep["low"], prep["high"]
    if low[0].numel():
        col, _ = K12.cgr_residual(prep["stream"], *low, ne, prep["zeta_k"],
                                  **prep["res_tables"])
    else:
        col = torch.empty(ne, dtype=torch.int32, device=prep["device"])
    if high[0].numel():
        K11.svb_decode(prep["stream"], *high, col, **prep["svb_tables"])
    return col


def decode_hybrid_device(hg, *, device="cuda") -> CSRGraph:
    """Decode a hybrid graph (StreamVByte chunks) on ``device`` into a host
    CSRGraph."""
    prep = hybrid_device_prep(hg, device=device)
    col = hybrid_device_run(prep)
    return CSRGraph(row_ptr=prep["row_ptr"], col_idx=col.cpu().numpy())
