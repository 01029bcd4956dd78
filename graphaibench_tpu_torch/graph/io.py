"""Binary on-disk graph format I/O.

The port's own copy of the readers and the writer (``save_graph``) of
``graphaibench_tpu/graph/io.py`` and of ``read_gr`` from
``graph/converters.py`` (same names, same arrays and files).
Reads the exact GraphAIBench dataset layout (reference
src/gnn/reader.cpp:414-457, src/common/graph.cc:190-222, README.md:95-110):

    <dir>/graph.meta.txt     text metadata (see Meta below)
    <dir>/graph.vertex.bin   int64 row pointers, nv+1 entries
    <dir>/graph.edge.bin     uint32/int32 column indices, ne entries
    <dir>/graph.vlabel.bin   uint8 vertex labels (optional)
    <dir>/graph.elabel.bin   per-edge labels/weights (optional)
    <dir>/graph.feats.bin    float32 vertex features, nv*feat_len (optional)
    <dir>/{train,val,test}.masks.bin  uint8 masks (optional)

graph.meta.txt token stream (whitespace separated, reader.cpp:426-431):
    nv ne vid_size eid_size vlabel_size elabel_size max_degree feat_len
    num_vertex_classes num_edge_classes
    [train_begin train_end train_count]
    [val_begin val_end val_count]
    [test_begin test_end test_count]
For bipartite graphs the first line is "nv_left nv_right" and nv =
nv_left + nv_right (graph.cc:194-197).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class Meta:
    nv: int
    ne: int
    vid_size: int = 4
    eid_size: int = 8
    vlabel_size: int = 1
    elabel_size: int = 2
    max_degree: int = 0
    feat_len: int = 0
    num_vertex_classes: int = 0
    num_edge_classes: int = 0
    # mask ranges: (begin, end, count); None when the meta has no mask lines
    train: Optional[tuple[int, int, int]] = None
    val: Optional[tuple[int, int, int]] = None
    test: Optional[tuple[int, int, int]] = None
    # bipartite
    nv_left: Optional[int] = None
    nv_right: Optional[int] = None


def read_meta(path: str) -> Meta:
    """Parse graph.meta.txt. ``path`` is the dataset directory."""
    fname = os.path.join(path, "graph.meta.txt")
    with open(fname) as f:
        lines = f.read().split("\n")
    first = lines[0].split()
    nv_left = nv_right = None
    if len(first) == 2:  # bipartite: "nv_left nv_right"
        nv_left, nv_right = int(first[0]), int(first[1])
        nv = nv_left + nv_right
        toks = [t for line in lines[1:] for t in line.split()]
    else:
        nv = int(first[0])
        toks = [t for line in lines[1:] for t in line.split()]
    vals = [int(t) for t in toks]

    def pop(n):
        nonlocal vals
        out, vals = vals[:n], vals[n:]
        return out

    (ne,) = pop(1)
    vid_size, eid_size, vlabel_size, elabel_size = pop(4)
    (max_degree,) = pop(1)
    meta = Meta(
        nv=nv, ne=ne, vid_size=vid_size, eid_size=eid_size,
        vlabel_size=vlabel_size, elabel_size=elabel_size,
        max_degree=max_degree, nv_left=nv_left, nv_right=nv_right,
    )
    # GNN-style metas continue with feat_len/classes; mining metas may stop.
    if vals:
        (meta.feat_len,) = pop(1)
    if vals:
        (meta.num_vertex_classes,) = pop(1)
    if vals:
        (meta.num_edge_classes,) = pop(1)
    for field in ("train", "val", "test"):
        if len(vals) >= 3:
            b, e, c = pop(3)
            setattr(meta, field, (b, e, c))
    return meta


def _check_sizes(row_ptr, col_idx, meta: Meta) -> None:
    if len(row_ptr) != meta.nv + 1 or len(col_idx) != meta.ne:
        raise ValueError(
            f"graph files hold {len(row_ptr)} row pointers and {len(col_idx)} "
            f"edges, the meta says nv={meta.nv} ne={meta.ne}")


def load_graph(path: str, *, with_vlabels: bool = False,
               with_elabels: bool = False, mmap: bool = False) -> CSRGraph:
    """Load a graph dataset directory into a CSRGraph.

    ``mmap=True`` maps vertex/edge files instead of reading them — the
    reference's out-of-core graphs (``SemiOutOfCoreGraph`` /
    ``OutOfCoreGraph``, include/graph.h:253, map_file graph.cc:44-56) for
    graphs beyond RAM. The arrays are read-only views; transforms that
    copy (orientation, selfloop, ...) materialize as usual, while
    streaming consumers (per-shard slicing in the partitioner, device
    uploads of row ranges) touch only the pages they use.
    """
    meta = read_meta(path)
    vpath = os.path.join(path, "graph.vertex.bin")
    epath = os.path.join(path, "graph.edge.bin")
    if mmap:
        row_ptr = np.memmap(vpath, dtype=np.int64, mode="r")
        # same bytes as the on-disk uint32; ids are < 2^31 per shard
        col_idx = np.memmap(epath, dtype=np.int32, mode="r")
        _check_sizes(row_ptr, col_idx, meta)
        vlabels = elabels = None
        vl_path = os.path.join(path, "graph.vlabel.bin")
        if with_vlabels and os.path.exists(vl_path):
            vlabels = np.memmap(vl_path, dtype=np.uint8, mode="r")[: meta.nv]
        el_path = os.path.join(path, "graph.elabel.bin")
        if with_elabels and os.path.exists(el_path):
            dt = {1: np.uint8, 2: np.int16, 4: np.float32}[meta.elabel_size]
            elabels = np.memmap(el_path, dtype=dt, mode="r")[: meta.ne]
        return CSRGraph(row_ptr=row_ptr, col_idx=col_idx, vlabels=vlabels,
                        elabels=elabels, n_left=meta.nv_left,
                        n_right=meta.nv_right)
    row_ptr = np.fromfile(vpath, dtype=np.int64)
    col_idx = np.fromfile(epath, dtype=np.uint32)
    _check_sizes(row_ptr, col_idx, meta)
    vlabels = elabels = None
    vl_path = os.path.join(path, "graph.vlabel.bin")
    if with_vlabels and os.path.exists(vl_path):
        vlabels = np.fromfile(vl_path, dtype=np.uint8)[: meta.nv]
    el_path = os.path.join(path, "graph.elabel.bin")
    if with_elabels and os.path.exists(el_path):
        # elabel dtype from elabel_size (2 = int16 in mining graphs; the
        # CF benchmark reinterprets them as ratings)
        dt = {1: np.uint8, 2: np.int16, 4: np.float32}[meta.elabel_size]
        elabels = np.fromfile(el_path, dtype=dt)[: meta.ne]
    return CSRGraph(row_ptr=row_ptr, col_idx=col_idx.astype(np.int32),
                    vlabels=vlabels, elabels=elabels,
                    n_left=meta.nv_left, n_right=meta.nv_right)


def save_graph(g: CSRGraph, path: str, *, meta: Optional[Meta] = None) -> None:
    """Write a CSRGraph in the reference binary layout."""
    os.makedirs(path, exist_ok=True)
    m = meta or Meta(nv=g.nv, ne=g.ne, max_degree=g.max_degree())
    m.nv, m.ne, m.max_degree = g.nv, g.ne, g.max_degree()
    lines = [f"{g.n_left} {g.n_right}" if g.is_bipartite() else str(m.nv),
             str(m.ne),
             f"{m.vid_size} {m.eid_size} {m.vlabel_size} {m.elabel_size}",
             str(m.max_degree), str(m.feat_len), str(m.num_vertex_classes),
             str(m.num_edge_classes)]
    for field in ("train", "val", "test"):
        rng = getattr(m, field)
        if rng is not None:
            lines.append(f"{rng[0]} {rng[1]} {rng[2]}")
    with open(os.path.join(path, "graph.meta.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    g.row_ptr.astype(np.int64).tofile(os.path.join(path, "graph.vertex.bin"))
    g.col_idx.astype(np.uint32).tofile(os.path.join(path, "graph.edge.bin"))
    if g.vlabels is not None:
        g.vlabels.astype(np.uint8).tofile(os.path.join(path, "graph.vlabel.bin"))
    if g.elabels is not None:
        g.elabels.tofile(os.path.join(path, "graph.elabel.bin"))


def read_gr(path: str) -> CSRGraph:
    """Galois binary .gr (version 1): uint64 header {version,
    edge_data_size, num_nodes, num_edges}, uint64 out-index per node,
    uint32 dst per edge (padded to 8B), optional edge data — the layout
    the reference's csgr reader mmaps (reader.cpp:170-246)."""
    with open(path, "rb") as f:
        hdr = np.fromfile(f, dtype=np.uint64, count=4)
        version, edata_size, nv, ne = (int(x) for x in hdr)
        if version not in (1, 2):
            raise ValueError(f"unsupported .gr version {version}")
        row_ptr = np.zeros(nv + 1, dtype=np.int64)
        row_ptr[1:] = np.fromfile(f, dtype=np.uint64, count=nv).astype(np.int64)
        col_idx = np.fromfile(f, dtype=np.uint32, count=ne)
        elabels = None
        if edata_size:
            if ne % 2:  # 4-byte padding to 8-byte boundary
                f.read(4)
            dt = {4: np.uint32, 8: np.uint64}[edata_size]
            elabels = np.fromfile(f, dtype=dt, count=ne)
    return CSRGraph(row_ptr=row_ptr, col_idx=col_idx.astype(np.int32),
                    elabels=elabels)


@dataclasses.dataclass
class GnnDataset:
    """A GNN training dataset: graph + features + labels + split masks.

    Mirrors what Model::load_data assembles (reference net.cpp:12-204).
    """

    graph: CSRGraph
    feats: np.ndarray          # float32 (nv, feat_len)
    labels: np.ndarray         # int32 (nv,) single-class, or uint8 (nv, C) multi
    train_mask: np.ndarray     # uint8 (nv,)
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    is_single_class: bool = True
    # mask ranges (begin, end, count) — the reference drives the loss over
    # the [begin, end) range with the mask applied inside it.
    train_range: tuple[int, int, int] = (0, 0, 0)
    val_range: tuple[int, int, int] = (0, 0, 0)
    test_range: tuple[int, int, int] = (0, 0, 0)

    @property
    def feat_len(self) -> int:
        return self.feats.shape[1]


def _range_mask(nv: int, rng: Optional[tuple[int, int, int]]) -> np.ndarray:
    """The bin path of the reference overwrites on-disk masks with the
    meta ranges (net.cpp:131-146)."""
    m = np.zeros(nv, dtype=np.uint8)
    if rng is not None:
        m[rng[0] : rng[1]] = 1
    return m


def load_gnn_dataset(
    path: str,
    *,
    is_single_class: bool = True,
    synth_feat_len: int = 0,
    seed: int = 0,
    mmap: bool = False,
) -> GnnDataset:
    """Load a dataset directory for GNN training.

    Follows the reference bin path: range-based masks from meta; labels from
    graph.vlabel.bin (random labels when absent, reader.cpp:385-407);
    features from graph.feats.bin. When the dataset ships no features
    (feat_len == 0 or missing file), deterministic random features of length
    ``synth_feat_len`` are synthesized so training remains exercisable.
    """
    meta = read_meta(path)
    g = load_graph(path, with_vlabels=True, mmap=mmap)
    nv = g.nv
    rng = np.random.default_rng(seed)
    num_cls = meta.num_vertex_classes or 1

    # labels
    if g.vlabels is not None:
        raw = g.vlabels.astype(np.int32)
    else:
        raw = rng.integers(1, num_cls + 1, size=nv).astype(np.int32)
    if is_single_class:
        labels = raw
    else:
        labels = np.zeros((nv, num_cls), dtype=np.uint8)
        valid = raw < num_cls
        labels[np.arange(nv)[valid], raw[valid]] = 1

    # features
    feats_path = os.path.join(path, "graph.feats.bin")
    if meta.feat_len > 0 and os.path.exists(feats_path):
        if mmap:
            feats = np.memmap(feats_path, dtype=np.float32,
                              mode="r").reshape(nv, meta.feat_len)
        else:
            feats = np.fromfile(feats_path,
                                dtype=np.float32).reshape(nv, meta.feat_len)
    else:
        fl = synth_feat_len or max(meta.feat_len, 32)
        # sparse-ish deterministic features: ~1% nonzero like bag-of-words
        feats = (rng.random((nv, fl)) < 0.05).astype(np.float32)

    return GnnDataset(
        graph=g,
        feats=feats,
        labels=labels,
        train_mask=_range_mask(nv, meta.train),
        val_mask=_range_mask(nv, meta.val),
        test_mask=_range_mask(nv, meta.test),
        num_classes=num_cls,
        is_single_class=is_single_class,
        train_range=meta.train or (0, 0, 0),
        val_range=meta.val or (0, 0, 0),
        test_range=meta.test or (0, 0, 0),
    )


def load_gnn_dataset_csgr(path: str, *, is_single_class: bool = True) -> GnnDataset:
    """Load a legacy csgr-format GNN dataset directory (the reference's
    mmap Galois path, reader.cpp:16-246): ``<name>.csgr`` graph plus
    sidecar text/binary files ``<name>-dims.txt`` (nv feat_len),
    ``<name>-feats.bin`` (float32), ``<name>-labels.txt`` (header
    "m num_classes" then one-hot rows), ``<name>-{train,val,test}_mask.txt``
    (header "begin end" then one 0/1 per line)."""
    csgrs = sorted(glob.glob(os.path.join(path, "*.csgr")))
    if not csgrs:
        raise FileNotFoundError(f"no .csgr file under {path}")
    name = os.path.basename(csgrs[0])[: -len(".csgr")]
    g = read_gr(csgrs[0])
    nv = g.nv

    def side(suffix):
        return os.path.join(path, f"{name}-{suffix}")

    with open(side("labels.txt")) as f:
        m, num_cls = (int(x) for x in f.readline().split())
        rows = np.loadtxt(f, dtype=np.int32, max_rows=m).reshape(m, num_cls)
    if is_single_class:
        labels = np.argmax(rows != 0, axis=1).astype(np.int32)
    else:
        labels = rows.astype(np.uint8)

    with open(side("dims.txt")) as f:
        dn, feat_len = (int(x) for x in f.read().split()[:2])
    feats = np.fromfile(side("feats.bin"), dtype=np.float32).reshape(dn, feat_len)

    masks, ranges = {}, {}
    for kind in ("train", "val", "test"):
        with open(side(f"{kind}_mask.txt")) as f:
            begin, end = (int(x) for x in f.readline().split())
            flags = np.loadtxt(f, dtype=np.uint8, max_rows=nv)
        mk = np.zeros(nv, dtype=np.uint8)
        rng = np.arange(nv)
        mk[(rng >= begin) & (rng < end) & (flags[:nv] != 0)] = 1
        masks[kind] = mk
        ranges[kind] = (begin, end, int(mk.sum()))

    return GnnDataset(
        graph=g, feats=feats, labels=labels,
        train_mask=masks["train"], val_mask=masks["val"],
        test_mask=masks["test"], num_classes=num_cls,
        is_single_class=is_single_class,
        train_range=ranges["train"], val_range=ranges["val"],
        test_range=ranges["test"],
    )
