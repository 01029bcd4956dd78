"""Hybrid compression: degree-thresholded scheme mix.

The port's own copy of ``graphaibench_tpu/compress/hybrid.py`` (same
names, same bytes; ``tests/test_torch_compress.py`` holds them equal).

Parity with src/structure/hybrid_encoder.cc: low-degree adjacency lists
use unary (zeta-delta CGR) coding, high-degree lists use a VByte scheme
— small lists compress best bit-packed, long lists decode fastest
byte-aligned.

One difference from the JAX copy: a row routed to CGR (degree below the
threshold) must be strictly increasing, as ``cgr.encode_graph`` requires of
every row, or ``encode_graph`` raises CGR's ``ValueError``. A repeated id
codes a gap of -1, which no decoder reads back (JAX's encoder writes such a
stream; its host decode raises ``IndexError`` and its device decode gives
ids past ``nv``). Rows routed to the VByte scheme may repeat ids."""

from __future__ import annotations

import dataclasses

import numpy as np

from graphaibench_tpu_torch.compress import cgr as cgr_mod
from graphaibench_tpu_torch.compress import vbyte as vbyte_mod
from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges

DEFAULT_DEGREE_THRESHOLD = 32


@dataclasses.dataclass
class HybridGraph:
    nv: int
    ne: int
    threshold: int
    zeta_k: int
    vbyte_scheme: str
    offsets: np.ndarray    # (nv+1,) int64 byte offsets
    data: bytes
    degrees: np.ndarray

    def compression_ratio(self) -> float:
        return (self.ne * 4) / max(len(self.data), 1)


def encode_graph(
    g: CSRGraph,
    *,
    threshold: int = DEFAULT_DEGREE_THRESHOLD,
    zeta_k: int = 2,
    vbyte_scheme: str = "streamvbyte",
) -> HybridGraph:
    cfg = cgr_mod.CgrConfig(zeta_k=zeta_k, res_seg_len=0, alignment="byte")
    enc_v = vbyte_mod._CODECS[vbyte_scheme][0]
    chunks = []
    offsets = np.zeros(g.nv + 1, dtype=np.int64)
    deg = g.degrees()
    _check_cgr_rows(g, deg < threshold)
    for v in range(g.nv):
        adj = g.neighbors(v)
        if deg[v] < threshold:
            bw = cgr_mod.encode_vertex(v, adj, cfg)
            bw.align(8)
            b = bw.getvalue()
        else:
            b = enc_v(adj, add_degree=False)
        chunks.append(b)
        offsets[v + 1] = offsets[v] + len(b)
    return HybridGraph(nv=g.nv, ne=g.ne, threshold=threshold, zeta_k=zeta_k,
                       vbyte_scheme=vbyte_scheme, offsets=offsets,
                       data=b"".join(chunks), degrees=deg)


def _check_cgr_rows(g: CSRGraph, low: np.ndarray) -> None:
    """CGR's ValueError unless every row marked in ``low`` is strictly
    increasing."""
    if not g.ne:
        return
    src, dst = g.coo()
    bad = (src[1:] == src[:-1]) & (dst[1:] <= dst[:-1]) & low[src[1:]]
    if bad.any():
        raise ValueError(
            "CGR requires strictly increasing adjacency lists; run "
            "transforms.sort_and_clean(g) first (hybrid sends row "
            f"{int(src[1:][bad][0])}, below the degree threshold, to CGR)")


def decode_vertex(hg: HybridGraph, v: int) -> np.ndarray:
    deg = int(hg.degrees[v])
    off = int(hg.offsets[v])
    if deg < hg.threshold:
        cfg = cgr_mod.CgrConfig(zeta_k=hg.zeta_k, res_seg_len=0, alignment="byte")
        cg = cgr_mod.CompressedGraph(
            nv=hg.nv, ne=hg.ne,
            offsets=np.zeros(1, dtype=np.int64), data=hg.data, cfg=cfg,
        )
        return cgr_mod.decode_vertex(cg, v, bit_offset=off * 8)
    dec = vbyte_mod._CODECS[hg.vbyte_scheme][1]
    return dec(hg.data, off, count=deg)


def decode_graph(hg: HybridGraph) -> CSRGraph:
    src, dst = [], []
    for v in range(hg.nv):
        adj = decode_vertex(hg, v)
        src.extend([v] * len(adj))
        dst.extend(adj.tolist())
    return from_edges(np.asarray(src, dtype=np.int64),
                      np.asarray(dst, dtype=np.int64), hg.nv)
