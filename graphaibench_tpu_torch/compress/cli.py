"""Compression CLI — parity with the reference compressor
(src/structure/compressor.cc:258 usage). The port's own copy of
``graphaibench_tpu/compress/cli.py``: files written by either package load
in the other (``tests/test_torch_compress.py``). Run as
``python -m graphaibench_tpu_torch.cli compress <command> ...``:

    compress <in_dir> <out_prefix> [-s scheme] [-z zeta_k] [-i] [-a align] [-p]
    decompress <prefix> <out_dir>
    verify <in_dir> <prefix>           (verify_compression.cc semantics)
    info <prefix>                      (query_compressed_graph_info)

schemes: cgr | streamvbyte | varintgb | hybrid. On-disk layout:
<prefix>.vertex.bin (int64 offsets), <prefix>.edge.bin (packed stream),
<prefix>.degree.bin (uint32, vbyte/hybrid), <prefix>.meta.json.
"""

from __future__ import annotations

import json
import os

import numpy as np

from graphaibench_tpu_torch.compress import cgr, hybrid, vbyte
from graphaibench_tpu_torch.graph.io import load_graph, save_graph


def permute_bytes_by_word(data: bytes) -> bytes:
    """Reverse the byte order inside each 32-bit word — the reference's
    ``-p`` flag (Compressor::permutate_bytes_by_word, compressor.cc:117:
    word-aligned streams are stored big-endian-per-word so a word-at-a-
    time decoder can shift bits MSB-first). Involution: applying twice
    restores the stream. Requires a word-aligned (len % 4 == 0) stream."""
    a = np.frombuffer(data, dtype=np.uint8)
    assert a.size % 4 == 0, "byte permutation requires a word-aligned stream"
    return a.reshape(-1, 4)[:, ::-1].tobytes()


def save_compressed(obj, prefix: str, *, permuted: bool = False):
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    obj.offsets.astype(np.int64).tofile(prefix + ".vertex.bin")
    data = permute_bytes_by_word(obj.data) if permuted else obj.data
    with open(prefix + ".edge.bin", "wb") as f:
        f.write(data)
    meta = {"nv": obj.nv, "ne": obj.ne, "permuted": bool(permuted)}
    if isinstance(obj, cgr.CompressedGraph):
        meta.update(scheme="cgr", **{
            k: getattr(obj.cfg, k)
            for k in ("zeta_k", "use_interval", "min_itv_len", "itv_seg_len",
                      "res_seg_len", "add_degree", "alignment")
        })
    elif isinstance(obj, vbyte.VbyteGraph):
        meta.update(scheme=obj.scheme)
        obj.degrees.astype(np.uint32).tofile(prefix + ".degree.bin")
    elif isinstance(obj, hybrid.HybridGraph):
        meta.update(scheme="hybrid", threshold=obj.threshold,
                    zeta_k=obj.zeta_k, vbyte_scheme=obj.vbyte_scheme)
        obj.degrees.astype(np.uint32).tofile(prefix + ".degree.bin")
    with open(prefix + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_compressed(prefix: str):
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    offsets = np.fromfile(prefix + ".vertex.bin", dtype=np.int64)
    with open(prefix + ".edge.bin", "rb") as f:
        data = f.read()
    if meta.get("permuted"):
        data = permute_bytes_by_word(data)  # involution: undo on load
    scheme = meta["scheme"]
    if scheme == "cgr":
        cfg = cgr.CgrConfig(
            zeta_k=meta["zeta_k"], use_interval=meta["use_interval"],
            min_itv_len=meta["min_itv_len"], itv_seg_len=meta["itv_seg_len"],
            res_seg_len=meta["res_seg_len"], add_degree=meta["add_degree"],
            alignment=meta["alignment"],
        )
        return cgr.CompressedGraph(nv=meta["nv"], ne=meta["ne"],
                                   offsets=offsets, data=data, cfg=cfg)
    degrees = np.fromfile(prefix + ".degree.bin", dtype=np.uint32).astype(np.int32)
    if scheme == "hybrid":
        return hybrid.HybridGraph(
            nv=meta["nv"], ne=meta["ne"], threshold=meta["threshold"],
            zeta_k=meta["zeta_k"], vbyte_scheme=meta["vbyte_scheme"],
            offsets=offsets, data=data, degrees=degrees,
        )
    return vbyte.VbyteGraph(nv=meta["nv"], ne=meta["ne"], scheme=scheme,
                            offsets=offsets, data=data, degrees=degrees)


def compress_cmd(in_dir: str, prefix: str, scheme: str = "cgr", *,
                 zeta_k: int = 2, use_interval: bool = False,
                 alignment: str = "bit", threshold: int = 32,
                 permuted: bool = False):
    g = load_graph(in_dir)
    if scheme == "cgr":
        if permuted and alignment != "word":
            raise SystemExit("-p requires word alignment (-a word), like the "
                             "reference compressor (compressor.cc:109)")
        obj = cgr.encode_graph(g, cgr.CgrConfig(
            zeta_k=zeta_k, use_interval=use_interval, alignment=alignment))
    elif scheme in ("streamvbyte", "varintgb"):
        obj = vbyte.encode_graph(g, scheme)
    elif scheme == "hybrid":
        obj = hybrid.encode_graph(g, threshold=threshold, zeta_k=zeta_k)
    else:
        raise SystemExit(f"unknown scheme {scheme!r}")
    if permuted and len(obj.data) % 4 != 0:
        raise SystemExit("-p requires a word-aligned stream "
                         f"(got {len(obj.data)} bytes)")
    save_compressed(obj, prefix, permuted=permuted)
    print(f"|V| {obj.nv} |E| {obj.ne} compressed_bytes {len(obj.data)} "
          f"ratio {obj.compression_ratio():.2f}x")
    return obj


def decode_any(obj):
    """Host decode of any compressed-graph container to a CSRGraph."""
    if isinstance(obj, cgr.CompressedGraph):
        return cgr.decode_graph(obj)
    if isinstance(obj, hybrid.HybridGraph):
        return hybrid.decode_graph(obj)
    return vbyte.decode_graph(obj)


def decompress_cmd(prefix: str, out_dir: str):
    obj = load_compressed(prefix)
    g = decode_any(obj)
    save_graph(g, out_dir)
    print(f"decompressed |V| {g.nv} |E| {g.ne} -> {out_dir}")
    return g


def verify_cmd(in_dir: str, prefix: str) -> bool:
    """verify_compression.cc: decode every adjacency list and compare."""
    g = load_graph(in_dir)
    obj = load_compressed(prefix)
    if isinstance(obj, cgr.CompressedGraph):
        dec = lambda v: cgr.decode_vertex(obj, v)
    elif isinstance(obj, hybrid.HybridGraph):
        dec = lambda v: hybrid.decode_vertex(obj, v)
    else:
        dec = lambda v: vbyte.decode_vertex(obj, v)
    for v in range(g.nv):
        if not np.array_equal(dec(v), g.neighbors(v)):
            print(f"Wrong (vertex {v})")
            return False
    print("Correct")
    return True


def main(argv: list[str]) -> int:
    if not argv:
        print("usage: compress|decompress|verify|info ...")
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "compress":
        opts = {}
        pos = []
        i = 0
        while i < len(rest):
            a = rest[i]
            if a == "-s":
                opts["scheme"] = rest[i + 1]; i += 2
            elif a == "-z":
                opts["zeta_k"] = int(rest[i + 1]); i += 2
            elif a == "-i":
                opts["use_interval"] = True; i += 1
            elif a == "-a":
                opts["alignment"] = rest[i + 1]; i += 2
            elif a == "-t":
                opts["threshold"] = int(rest[i + 1]); i += 2
            elif a == "-p":
                opts["permuted"] = True; i += 1
            else:
                pos.append(a); i += 1
        scheme = opts.pop("scheme", "cgr")
        compress_cmd(pos[0], pos[1], scheme, **opts)
        return 0
    if cmd == "decompress":
        decompress_cmd(rest[0], rest[1])
        return 0
    if cmd == "verify":
        return 0 if verify_cmd(rest[0], rest[1]) else 1
    if cmd == "info":
        obj = load_compressed(rest[0])
        print(f"|V| {obj.nv} |E| {obj.ne} bytes {len(obj.data)} "
              f"ratio {obj.compression_ratio():.2f}x")
        return 0
    print(f"unknown command {cmd!r}")
    return 2
