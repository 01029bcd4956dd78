"""VByte adjacency codecs: StreamVByte and VarintGB.

The port's own copy of ``graphaibench_tpu/compress/vbyte.py`` (same names,
same bytes; ``tests/test_torch_compress.py`` holds them equal).

Byte-level parity with the reference (src/structure/vbyte_encoder.cc):

StreamVByte per adjacency list (delta-1 "d1" transform: first value
absolute, then gaps v[i] - v[i-1]):
    [count: uint32] [keys: ceil(count/4) bytes, four 2-bit byte-lengths
    per key byte, LSB-first] [data: variable bytes, little-endian]
padded to a whole number of 32-bit words.

VarintGB (group varint): groups of 4 values, each group = 1 tag byte
(four 2-bit lengths, LSB-first) followed by the 4 variable-length
little-endian values; final partial group zero-padded to 4 lanes.

Per-vertex streams are word-aligned; ``.vertex.bin`` offsets count words
(compressor.cc compute_ptrs with word_aligned)."""

from __future__ import annotations

import dataclasses

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges


def _byte_len_code(v: int) -> int:
    if v < 1 << 8:
        return 0
    if v < 1 << 16:
        return 1
    if v < 1 << 24:
        return 2
    return 3


def _deltas(adj: np.ndarray) -> list[int]:
    """d1 transform: first absolute, then consecutive gaps."""
    if len(adj) == 0:
        return []
    out = [int(adj[0])]
    out.extend(int(b) - int(a) for a, b in zip(adj, adj[1:]))
    return out


def streamvbyte_encode(adj: np.ndarray, *, add_degree: bool = True) -> bytes:
    vals = _deltas(adj)
    count = len(vals)
    out = bytearray()
    if add_degree:
        out += int(count).to_bytes(4, "little")
    keys = bytearray((count + 3) // 4)
    data = bytearray()
    for i, v in enumerate(vals):
        code = _byte_len_code(v)
        keys[i >> 2] |= code << ((i & 3) * 2)
        data += int(v).to_bytes(code + 1, "little")
    out += keys + data
    out += b"\x00" * ((-len(out)) % 4)  # word alignment
    return bytes(out)


def streamvbyte_decode(buf: bytes, offset: int = 0, count: int | None = None) -> np.ndarray:
    pos = offset
    if count is None:
        count = int.from_bytes(buf[pos : pos + 4], "little")
        pos += 4
    key_len = (count + 3) // 4
    keys = buf[pos : pos + key_len]
    pos += key_len
    vals = np.empty(count, dtype=np.int64)
    for i in range(count):
        code = (keys[i >> 2] >> ((i & 3) * 2)) & 3
        vals[i] = int.from_bytes(buf[pos : pos + code + 1], "little")
        pos += code + 1
    return np.cumsum(vals).astype(np.int32)


def varintgb_encode(adj: np.ndarray, *, add_degree: bool = True) -> bytes:
    vals = _deltas(adj)
    count = len(vals)
    out = bytearray()
    if add_degree:
        out += int(count).to_bytes(4, "little")
    for g0 in range(0, count, 4):
        group = vals[g0 : g0 + 4] + [0] * max(0, g0 + 4 - count)
        tag = 0
        body = bytearray()
        for lane, v in enumerate(group):
            code = _byte_len_code(v)
            tag |= code << (lane * 2)
            body += int(v).to_bytes(code + 1, "little")
        out.append(tag)
        out += body
    out += b"\x00" * ((-len(out)) % 4)
    return bytes(out)


def varintgb_decode(buf: bytes, offset: int = 0, count: int | None = None) -> np.ndarray:
    pos = offset
    if count is None:
        count = int.from_bytes(buf[pos : pos + 4], "little")
        pos += 4
    vals = np.empty(count, dtype=np.int64)
    i = 0
    while i < count:
        tag = buf[pos]
        pos += 1
        for lane in range(4):
            code = (tag >> (lane * 2)) & 3
            v = int.from_bytes(buf[pos : pos + code + 1], "little")
            pos += code + 1
            if i < count:
                vals[i] = v
                i += 1
    return np.cumsum(vals).astype(np.int32)


_CODECS = {
    "streamvbyte": (streamvbyte_encode, streamvbyte_decode),
    "varintgb": (varintgb_encode, varintgb_decode),
}


@dataclasses.dataclass
class VbyteGraph:
    nv: int
    ne: int
    scheme: str
    offsets: np.ndarray   # (nv+1,) int64 word offsets
    data: bytes
    degrees: np.ndarray   # (nv,) int32 (.degree.bin, Compressor::write_degrees)

    def compression_ratio(self) -> float:
        return (self.ne * 4) / max(len(self.data), 1)


def encode_graph(g: CSRGraph, scheme: str = "streamvbyte") -> VbyteGraph:
    enc, _ = _CODECS[scheme]
    chunks = []
    offsets = np.zeros(g.nv + 1, dtype=np.int64)
    for v in range(g.nv):
        b = enc(g.neighbors(v))
        chunks.append(b)
        offsets[v + 1] = offsets[v] + len(b) // 4
    return VbyteGraph(nv=g.nv, ne=g.ne, scheme=scheme, offsets=offsets,
                      data=b"".join(chunks), degrees=g.degrees())


def decode_vertex(vg: VbyteGraph, v: int) -> np.ndarray:
    _, dec = _CODECS[vg.scheme]
    return dec(vg.data, int(vg.offsets[v]) * 4)


def decode_graph(vg: VbyteGraph) -> CSRGraph:
    src, dst = [], []
    for v in range(vg.nv):
        adj = decode_vertex(vg, v)
        src.extend([v] * len(adj))
        dst.extend(adj.tolist())
    return from_edges(np.asarray(src, dtype=np.int64),
                      np.asarray(dst, dtype=np.int64), vg.nv)
