"""Host-side graph partitioning: the offline partitioner.

Counterpart of ``graphaibench_tpu/graph/partition.py``, a copy of its
numpy code held bit-equal to it (the files byte-equal) by
``tests/test_torch_partition.py``. Parity with PartitionedGraph
(src/partitioner/graph_partition.cc, include/graph_partition.h:10-63):

  edgecut_partition_1d          — contiguous vertex ranges balanced by
                                  edge count (graph_partition.cc:37-67)
  write_partitions /            — persist/load induced partitions as
  read_partition                  <prefix>-part<i> binary CSR dirs
                                  (graph_partition.cc:18-35; the files
                                  each rank of the reference's NVSHMEM
                                  flow loads, multigpu_nvshmem.cu:13-120)
  edgecut_induced_partition_1d  — each chunk + its 1-hop halo, locally
                                  reindexed with master ranges
                                  (graph_partition.cc:128-182)
  csr_segmenting                — column-range blocking for cache
                                  locality (graph_partition.cc:184-275);
                                  a host function only, wired into no
                                  kernel's layout
  partition_2d                  — by cluster assignment
                                  (graph_partition.cc:276-360)

plus the multi-device edge-chunk Scheduler (src/common/scheduler.cc):
round_robin, vertex_chunking, least_first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges


def edgecut_partition_1d(g: CSRGraph, num_parts: int) -> np.ndarray:
    """Contiguous vertex ranges with ~equal edge counts. Returns
    boundaries (num_parts+1,): part p owns [b[p], b[p+1])."""
    target = g.ne / num_parts
    bounds = [0]
    for p in range(1, num_parts):
        # first vertex whose cumulative edge count reaches p*target
        v = int(np.searchsorted(g.row_ptr[1:], p * target, side="left")) + 1
        v = max(v, bounds[-1])
        bounds.append(min(v, g.nv))
    bounds.append(g.nv)
    return np.asarray(bounds, dtype=np.int64)


@dataclasses.dataclass
class InducedPartition:
    """One chunk of edgecut_induced_partition1D: the owned vertex range
    plus its 1-hop halo, reindexed locally. Local ids [0, num_masters)
    are the owned vertices in global order; halo vertices follow."""

    subgraph: CSRGraph          # local reindexed graph (masters + halo)
    local_to_global: np.ndarray  # (n_local,) int32
    num_masters: int            # == local_begin..local_end of the reference
    global_range: tuple[int, int]


def edgecut_induced_partition_1d(
    g: CSRGraph, num_parts: int
) -> list[InducedPartition]:
    """graph_partition.cc:128-182 semantics: chunk + 1-hop boundary set,
    local reindex, master range recorded. Only edges out of master
    vertices are kept (each part computes its own rows)."""
    bounds = edgecut_partition_1d(g, num_parts)
    parts = []
    src_all, dst_all = g.coo()
    for p in range(num_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        emask = (src_all >= lo) & (src_all < hi)
        src, dst = src_all[emask], dst_all[emask]
        masters = np.arange(lo, hi, dtype=np.int64)
        halo = np.setdiff1d(np.unique(dst), masters)
        l2g = np.concatenate([masters, halo]).astype(np.int32)
        g2l = np.full(g.nv, -1, dtype=np.int64)
        g2l[l2g] = np.arange(len(l2g))
        sub = from_edges(g2l[src], g2l[dst], len(l2g), sort_neighbors=False)
        parts.append(
            InducedPartition(
                subgraph=sub,
                local_to_global=l2g,
                num_masters=hi - lo,
                global_range=(lo, hi),
            )
        )
    return parts


def write_partitions(g: CSRGraph, num_parts: int, prefix: str,
                     verbose: bool = False) -> list[InducedPartition]:
    """Persist the induced 1-D partitions as ``<prefix>-part<i>``
    binary CSR dirs (graph_partition.cc:18-23 layout) so each host of a
    multi-host run loads only its own shard — the reference's per-PE
    partition files. The local->global map, master count, and global
    range ride in a ``partition.npz`` sidecar (the reference encodes
    ownership implicitly as ``u / subgraph_size``; the induced local
    reindex needs the explicit map)."""
    import os

    from graphaibench_tpu_torch.graph.io import save_graph

    parts = edgecut_induced_partition_1d(g, num_parts)
    for i, p in enumerate(parts):
        if verbose:
            print(f"Writing subgraph[{i}]")
        d = f"{prefix}-part{i}"
        save_graph(p.subgraph, d)
        np.savez(os.path.join(d, "partition.npz"),
                 local_to_global=p.local_to_global,
                 num_masters=np.int64(p.num_masters),
                 global_range=np.asarray(p.global_range, np.int64))
    return parts


def read_partition(prefix: str, i: int) -> InducedPartition:
    """Load one ``<prefix>-part<i>`` partition
    (graph_partition.cc:31-35 / Graph(infile+"-part"+i) analog)."""
    import os

    from graphaibench_tpu_torch.graph.io import load_graph

    d = f"{prefix}-part{i}"
    sub = load_graph(d)
    z = np.load(os.path.join(d, "partition.npz"))
    return InducedPartition(
        subgraph=sub,
        local_to_global=z["local_to_global"],
        num_masters=int(z["num_masters"]),
        global_range=tuple(int(x) for x in z["global_range"]),
    )


@dataclasses.dataclass
class CsrSegments:
    """Column-range segmented CSR: segment k holds the edges whose dst
    lies in [k*range_width, (k+1)*range_width). Aggregating segment by
    segment keeps the gathered rows of X inside a cache-sized
    window (graph_partition.cc:184-275)."""

    segments: list[CSRGraph]
    edge_perm: list[np.ndarray]  # per segment: original edge ids
    range_width: int


def csr_segmenting(g: CSRGraph, range_width: int) -> CsrSegments:
    src, dst = g.coo()
    eid = np.arange(g.ne, dtype=np.int64)
    num_seg = (g.nv + range_width - 1) // range_width
    segs, perms = [], []
    seg_of = dst // range_width
    for k in range(num_seg):
        m = seg_of == k
        segs.append(from_edges(src[m], dst[m], g.nv, sort_neighbors=False))
        perms.append(eid[m])
    return CsrSegments(segments=segs, edge_perm=perms, range_width=range_width)


def partition_2d(g: CSRGraph, clusters: np.ndarray, num_clusters: int):
    """2-D partition by cluster ids (graph_partition.cc:276-360): block
    (i, j) holds edges from cluster i to cluster j. Returns a dict
    {(i, j): (src, dst)} of global-id edge lists."""
    src, dst = g.coo()
    ci, cj = clusters[src], clusters[dst]
    blocks = {}
    for i in range(num_clusters):
        for j in range(num_clusters):
            m = (ci == i) & (cj == j)
            if m.any():
                blocks[(i, j)] = (src[m], dst[m])
    return blocks


# ---- edge-chunk schedulers (scheduler.cc) --------------------------------

def schedule_round_robin(ne: int, num_devices: int, chunk_size: int = 1024):
    """Chunked round-robin edge assignment (scheduler.cc:34)."""
    eid = np.arange(ne, dtype=np.int64)
    chunk = eid // chunk_size
    return [eid[chunk % num_devices == d] for d in range(num_devices)]


def schedule_vertex_chunking(g: CSRGraph, num_devices: int):
    """Edges grouped by source-vertex chunks (scheduler.cc:100)."""
    bounds = edgecut_partition_1d(g, num_devices)
    return [
        np.arange(g.row_ptr[bounds[d]], g.row_ptr[bounds[d + 1]], dtype=np.int64)
        for d in range(num_devices)
    ]


def schedule_least_first(g: CSRGraph, num_devices: int, chunk_size: int = 1024):
    """Least-loaded-first by the workload estimate min(deg_u, deg_v)
    (scheduler.cc:3-21,133)."""
    src, dst = g.coo()
    deg = g.degrees()
    cost = np.minimum(deg[src], deg[dst]).astype(np.int64)
    ne = g.ne
    loads = np.zeros(num_devices, dtype=np.int64)
    assign = [[] for _ in range(num_devices)]
    for start in range(0, ne, chunk_size):
        end = min(start + chunk_size, ne)
        d = int(np.argmin(loads))
        assign[d].append(np.arange(start, end, dtype=np.int64))
        loads[d] += int(cost[start:end].sum())
    return [np.concatenate(a) if a else np.empty(0, dtype=np.int64) for a in assign]
