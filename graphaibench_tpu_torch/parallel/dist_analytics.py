"""The distributed analytics: the analytics solvers with the graph
vertex-sharded over the ranks of a ``torch.distributed`` group.

Counterpart of ``graphaibench_tpu/parallel/dist_analytics.py``. Every rank
cuts the same host partition of the reverse graph
(``partition.build_sharded_graph``, contiguous vertex blocks with 1-hop
halo plans) and keeps its own ``RankShard``, whose tables it builds on its
device (``shard_ell.build_shard_ell``); a sweep exchanges the halo once
(``halo.halo_exchange``) and runs one pull on the rank's tables:

  * BFS, SSSP and CC (``_pull_fixpoint``): K8 (``csrc/ell_pull.cu``) on
    the forward table over the own and halo rows, a min (BFS, CC) or the
    min-plus with packed slot weights (SSSP);
  * k-core and BC: K8 as an int32 or float32 sum;
  * PageRank: K1 (``csrc/ell_spmm.cu``) at one column on the own and the
    halo table, with the 1/outdeg weights packed per slot;
  * triangle counting: K9 (``csrc/tc_count.cu``) over the rank's chunk of
    DAG edges (``distributed_triangle_count``) or over one block of a 2-D
    partition (``distributed_triangle_count_2d``), then one all-reduce.

A solver runs in every rank of ``group`` (the default group by default)
with the rank's ``device``, under ``torch.no_grad``; its collectives must
be called by every rank in the same order, which the loops keep since
their exits are all-reduced. JAX runs each fixpoint in one dispatch (a
``lax.while_loop`` inside ``shard_map``); here each is a Python loop that
all-reduces its change flag, or its error, once a sweep and reads it on
the host, as the single-device solvers read theirs. The sweep, iteration
and level counts returned equal JAX's. The vertex solvers return the
rank's own rows, (nv_pad,), in the layout of the partition: ``gather_own``
gathers the (nv,) result in vertex order. Each takes the host graph, or
the ``RankGraph`` that ``pull_graph`` (or ``pagerank_graph``) built of it,
so that several solves share one partition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from graphaibench_tpu_torch.analytics.tc import sorted_dag
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.graph.partition import partition_2d
from graphaibench_tpu_torch.ops.device_graph import pack_slot_values
from graphaibench_tpu_torch.ops.tc_count import edges_between, tc_count
from graphaibench_tpu_torch.parallel.halo import (
    all_gather_rows,
    all_reduce_sum,
    halo_exchange,
    rank_graph_arrays,
)
from graphaibench_tpu_torch.parallel.partition import build_sharded_graph
from graphaibench_tpu_torch.parallel.shard_ell import (
    ShardEll,
    build_shard_ell,
    ell_gather_reduce,
    ell_gather_reduce_plus,
    pack_shard_values,
    slot_spmm_packed,
)

_DIST_INF = 2**30      # BFS's "unreached", as in JAX


@dataclasses.dataclass(frozen=True)
class RankGraph:
    """One rank's share of a vertex partition of the reverse graph, on its
    device: its tables by part (``"all"``: the forward table over the own
    and halo rows; ``"own"`` and ``"halo"`` apart), its static slot
    weights (e_max,) or None, and its halo plan."""

    nv: int
    nv_pad: int
    rank: int
    size: int
    tables: dict            # part -> ShardEll (forward tables only)
    edge_w: Optional[torch.Tensor]
    send_idx: torch.Tensor  # (P, s_max) int64
    halo_map: torch.Tensor  # (h_max,) int64
    group: object = None

    @property
    def device(self) -> torch.device:
        return self.send_idx.device

    def gid(self) -> torch.Tensor:
        """(nv_pad,) int32 global ids of the rank's rows (those from nv
        on are padding)."""
        return (self.rank * self.nv_pad
                + torch.arange(self.nv_pad, dtype=torch.int32,
                               device=self.device))

    def extended(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's (nv_pad,) ``x`` followed by its halo rows, received
        from their owners (one all-to-all)."""
        halo = halo_exchange(x[:, None], self.send_idx, self.halo_map,
                             self.group)
        return torch.cat([x, halo[:, 0]])

    def anywhere(self, mask: torch.Tensor) -> bool:
        """Whether ``mask`` holds on any row of any rank (one all-reduce
        and one host read)."""
        flag = mask.any().to(torch.int32).reshape(1)
        return int(all_reduce_sum(flag, self.group)) > 0


def rank_graph(rg: CSRGraph, w_rev: Optional[np.ndarray], *,
               parts=("all",), group=None, device="cuda") -> RankGraph:
    """This rank's share of the partition of ``rg`` (the reverse graph:
    row r holds r's in-edges) into the group's size of vertex blocks,
    with ``w_rev`` its edge weights in rg's CSR order (None: unweighted);
    the forward tables of ``parts`` built on ``device``. Every rank cuts
    the whole partition on the host, as JAX does, and keeps its own
    shard."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    w = np.ones(rg.ne, np.float32) if w_rev is None else w_rev
    sg = build_sharded_graph(rg, np.asarray(w, np.float32), size)
    shard = sg.shard(rank)
    tables = {p: build_shard_ell(shard, part=p, with_trans=False,
                                 device=device) for p in parts}
    plan = rank_graph_arrays(shard, plain=False, device=device)
    edge_w = (None if w_rev is None
              else torch.from_numpy(shard.edge_w).to(device))
    return RankGraph(nv=sg.nv, nv_pad=sg.nv_pad, rank=rank, size=size,
                     tables=tables, edge_w=edge_w,
                     send_idx=plan["send_idx"], halo_map=plan["halo_map"],
                     group=group)


def pull_graph(g: CSRGraph, weights: Optional[np.ndarray] = None, *,
               group=None, device="cuda") -> RankGraph:
    """The rank's graph of the pull solvers (BFS, SSSP, CC, k-core, BC):
    the reverse graph's forward table over the own and halo rows; with
    ``weights`` (g's (ne,) edge weights) each reverse edge carries its
    original edge's weight, mapped through the transpose permutation."""
    w_rev = (None if weights is None else np.asarray(weights, np.float32)[
        T.transpose_edge_permutation(g)])
    return rank_graph(T.reverse(g), w_rev, group=group, device=device)


def pagerank_graph(g: CSRGraph, rg: Optional[CSRGraph] = None, *,
                   group=None, device="cuda") -> RankGraph:
    """The rank's graph of PageRank: the own and the halo table of the
    reverse graph ``rg`` (computed if None), each reverse edge (v -> u)
    weighted 1/outdeg(u) of the original edge u -> v."""
    if rg is None:
        rg = T.reverse(g)
    out_deg = np.maximum(g.degrees(), 1).astype(np.float32)
    w = (1.0 / out_deg[rg.col_idx]).astype(np.float32)
    return rank_graph(rg, w, parts=("own", "halo"), group=group,
                      device=device)


def _rank_graph_of(g, make) -> RankGraph:
    return g if isinstance(g, RankGraph) else make()


def gather_own(x: torch.Tensor, nv: int, group=None) -> torch.Tensor:
    """The (nv,) result in vertex order, on every rank, from each rank's
    own rows ``x`` (nv_pad,) (one all-gather)."""
    return all_gather_rows(x, group)[:nv]


# ---- the pull fixpoints: BFS, SSSP, CC -------------------------------------

@torch.no_grad()
def _pull_fixpoint(rgph: RankGraph, x: torch.Tensor, relax, *,
                   max_iters: Optional[int] = None,
                   weighted: bool = False):
    """x_own <- relax(x_own, m), m[r] = min over the in-edges (c -> r) of
    x_ext[c], or of x_ext[c] + w(c -> r) where ``weighted`` (the tropical
    min-plus of SSSP), until no rank changes or after ``max_iters`` sweeps
    (default nv + 1). Returns (x_own, sweeps)."""
    se: ShardEll = rgph.tables["all"]
    packed = None
    if weighted:
        if rgph.edge_w is None:
            raise ValueError("the rank's graph was built without weights")
        packed = pack_slot_values(se.fwd, rgph.edge_w)
    limit = max_iters if max_iters is not None else rgph.nv + 1
    it, changed = 0, True
    while changed and it < limit:
        x_ext = rgph.extended(x)
        if packed is None:
            m = ell_gather_reduce(se.fwd, x_ext, rgph.nv_pad, "min",
                                  se.sentinel)
        else:
            m = ell_gather_reduce_plus(se.fwd, packed, x_ext, rgph.nv_pad,
                                       "min", se.sentinel)
        new = relax(x, m)
        changed = rgph.anywhere(new != x)
        x, it = new, it + 1
    return x, it


def distributed_bfs(g, source: int, *, group=None, device="cuda"):
    """BFS depths, a unit Bellman-Ford fixpoint (depth[v] <- min(depth[v],
    min over in-neighbours + 1)), one halo exchange a sweep. ``g``: the
    graph, or its ``pull_graph``. Returns (the rank's depths (nv_pad,)
    int32, unreachable 2**30, sweeps)."""
    rgph = _rank_graph_of(g, lambda: pull_graph(g, group=group,
                                                device=device))
    x = torch.where(rgph.gid() == source, 0, _DIST_INF).to(torch.int32)

    def relax(x, m):
        # K8's identity is INT32_MAX: clamp before the + 1
        return torch.minimum(x, torch.clamp(m, max=_DIST_INF - 1) + 1)

    return _pull_fixpoint(rgph, x, relax)


def distributed_sssp(g, weights: Optional[np.ndarray], source: int, *,
                     max_iters: Optional[int] = None, group=None,
                     device="cuda"):
    """Single-source shortest paths, Bellman-Ford as a min-plus fixpoint
    (dist[v] <- min(dist[v], min over in-edges (u -> v) of dist[u] +
    w(u, v))) on slot weights packed once a solve. ``g``: the graph with
    its (ne,) ``weights``, or its ``pull_graph(g, weights)`` (``weights``
    then unused). Returns (the rank's distances (nv_pad,) float32,
    unreachable +inf, sweeps)."""
    rgph = _rank_graph_of(g, lambda: pull_graph(g, weights, group=group,
                                                device=device))
    x = torch.where(rgph.gid() == source, 0.0, float("inf")).to(
        torch.float32)
    return _pull_fixpoint(rgph, x, torch.minimum, max_iters=max_iters,
                          weighted=True)


def distributed_cc(g, *, group=None, device="cuda"):
    """Connected components by min-label propagation (labels: global
    vertex ids). Expects a symmetric graph. Returns (the rank's labels
    (nv_pad,) int32, sweeps)."""
    rgph = _rank_graph_of(g, lambda: pull_graph(g, group=group,
                                                device=device))
    return _pull_fixpoint(rgph, rgph.gid(), torch.minimum)


# ---- the sum pulls: k-core, BC ---------------------------------------------

def _sum_pull(rgph: RankGraph, col: torch.Tensor) -> torch.Tensor:
    """The sum of ``col`` over each own row's in-neighbours (one halo
    exchange and one K8 sum)."""
    se: ShardEll = rgph.tables["all"]
    return ell_gather_reduce(se.fwd, rgph.extended(col), rgph.nv_pad, "sum",
                             se.sentinel)


@torch.no_grad()
def distributed_kcore(g, *, group=None, device="cuda"):
    """Coreness by bulk peeling, a nested fixpoint: at level k peel the
    live vertices of live degree <= k until none is left, the live
    degrees one sum pull a peel. Expects a symmetric graph. Returns (the
    rank's coreness (nv_pad,) int32, peel levels)."""
    rgph = _rank_graph_of(g, lambda: pull_graph(g, group=group,
                                                device=device))

    def live_deg(alive):
        return torch.where(alive, _sum_pull(rgph, alive.to(torch.int32)), 0)

    alive = rgph.gid() < rgph.nv
    deg = live_deg(alive)
    core = torch.zeros(rgph.nv_pad, dtype=torch.int32, device=rgph.device)
    k = 0
    more = rgph.anywhere(alive)
    while more:
        changed = True
        while changed:
            peel = alive & (deg <= k)
            core = torch.where(peel, k, core)
            alive = alive & ~peel
            deg = live_deg(alive)
            changed = rgph.anywhere(peel)
        more = rgph.anywhere(alive)
        k += 1
    return core, k


@torch.no_grad()
def distributed_bc(g, sources, *, group=None, device="cuda") -> torch.Tensor:
    """Betweenness centrality (Brandes) summed over ``sources``: per
    source a level-synchronous forward sigma propagation, then the
    backward dependency accumulation from the deepest level that has
    vertices, each level one sum pull. Expects a symmetric graph. Returns
    the rank's (nv_pad,) float32 scores."""
    rgph = _rank_graph_of(g, lambda: pull_graph(g, group=group,
                                                device=device))
    gid = rgph.gid()
    bc = torch.zeros(rgph.nv_pad, dtype=torch.float32, device=rgph.device)
    for s in sources:
        at = gid == int(s)
        dist_ = torch.where(at, 0, -1).to(torch.int32)
        sigma = at.to(torch.float32)
        front, lvl, go = at, 0, True
        while go:
            reach = _sum_pull(rgph, torch.where(front, sigma, 0.0))
            front = (reach > 0) & (dist_ < 0)
            sigma = torch.where(front, reach, sigma)
            dist_ = torch.where(front, lvl + 1, dist_)
            go = rgph.anywhere(front)
            lvl += 1
        # the forward loop overshoots by one empty level: start at lvl - 1
        delta = torch.zeros_like(bc)
        for lvl in range(max(lvl - 1, 0), 0, -1):
            val = torch.where((dist_ == lvl) & (sigma > 0),
                              (1.0 + delta)
                              / torch.where(sigma > 0, sigma, 1.0), 0.0)
            acc = _sum_pull(rgph, val)
            delta = delta + torch.where(dist_ == lvl - 1, sigma * acc, 0.0)
        bc = bc + torch.where(at, 0.0, delta)
    return bc


# ---- PageRank ---------------------------------------------------------------

@torch.no_grad()
def distributed_pagerank(g, rg: Optional[CSRGraph] = None, *,
                         damp: float = 0.85, epsilon: float = 1e-4,
                         max_iter: int = 100, group=None, device="cuda"):
    """PageRank with the reference's constants: each iteration one halo
    exchange and K1 at one column on the own and the halo table, the L1
    change all-reduced. ``g``: the graph (``rg`` its reverse, computed if
    None), or its ``pagerank_graph``. Returns (the rank's scores (nv_pad,)
    float32, iterations)."""
    rgph = _rank_graph_of(g, lambda: pagerank_graph(g, rg, group=group,
                                                    device=device))
    nv, nv_pad = rgph.nv, rgph.nv_pad
    own, halo = rgph.tables["own"], rgph.tables["halo"]
    wp_own = pack_shard_values(own, rgph.edge_w)
    wp_halo = pack_shard_values(halo, rgph.edge_w)
    own_valid = (rgph.gid() < nv)[:, None]
    x = torch.where(own_valid, 1.0 / nv, 0.0).to(torch.float32)
    base = (1.0 - damp) / nv
    eps32 = float(np.float32(epsilon))   # JAX compares in float32
    err, it = float("inf"), 0
    while err >= eps32 and it < max_iter:
        x_halo = halo_exchange(x, rgph.send_idx, rgph.halo_map, rgph.group)
        inc = (slot_spmm_packed(nv_pad, own, wp_own, x)
               + slot_spmm_packed(nv_pad, halo, wp_halo, x_halo))
        new = torch.where(own_valid, base + damp * inc, 0.0)
        err = float(all_reduce_sum((new - x).abs().sum(), rgph.group))
        x, it = new, it + 1
    return x[:, 0], it


# ---- triangle counting ------------------------------------------------------

def _as_int32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


@torch.no_grad()
def distributed_triangle_count(g: CSRGraph, *, group=None,
                               device="cuda") -> int:
    """Exact triangle count with the DAG's edges split over the ranks:
    each rank holds the DAG's CSR, replicated, and counts its contiguous
    chunk of ceil(ne / P) edges with K9; one all-reduce sums the counts.
    Every rank returns the total."""
    dag = sorted_dag(g)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    per = -(-dag.ne // size)
    lo, hi = min(rank * per, dag.ne), min((rank + 1) * per, dag.ne)
    src, dst = dag.coo()
    edges = edges_between(_as_int32(dag.row_ptr, device),
                          _as_int32(dag.col_idx, device),
                          _as_int32(src[lo:hi], device),
                          _as_int32(dst[lo:hi], device), id_bound=dag.nv)
    return int(all_reduce_sum(tc_count(edges), group))


def block_edges_2d(dag: CSRGraph, s: int, i: int, j: int, *,
                   device="cuda"):
    """Block (i, j) of the s x s (cluster x cluster) partition of ``dag``
    (``graph.partition.partition_2d``, equal contiguous vertex clusters)
    laid out for K9: one local CSR of the rows of clusters i and j (i's,
    then j's), whose neighbour ids stay global, and the block's edges by
    local row ids. K9 hashes ids by value, and the plain version's pad,
    nv + 1, lies above every global id."""
    rows_per = -(-dag.nv // s)
    clusters = np.arange(dag.nv, dtype=np.int64) // rows_per
    empty = np.zeros(0, np.int64)
    bs, bd = partition_2d(dag, clusters, s).get((i, j), (empty, empty))
    spans = [(min(c * rows_per, dag.nv), min((c + 1) * rows_per, dag.nv))
             for c in ((i,) if i == j else (i, j))]
    rp = np.asarray(dag.row_ptr, np.int64)
    deg = np.concatenate([np.diff(rp[a:b + 1]) for a, b in spans])
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    col = np.concatenate([dag.col_idx[rp[a]:rp[b]] for a, b in spans])
    # cluster j's rows follow cluster i's
    shift_j = 0 if i == j else spans[0][1] - spans[0][0]
    return edges_between(_as_int32(row_ptr, device), _as_int32(col, device),
                         _as_int32(bs - spans[0][0], device),
                         _as_int32(bd - spans[-1][0] + shift_j, device),
                         id_bound=dag.nv)


@torch.no_grad()
def distributed_triangle_count_2d(g: CSRGraph, *, group=None,
                                  device="cuda") -> int:
    """Exact triangle count on a 2-D (cluster x cluster) partition of the
    DAG, s x s blocks with s = isqrt(P): rank (i, j) = i s + j holds only
    block (i, j)'s edges and the rows of clusters i and j
    (``block_edges_2d``) and counts them with K9. The ranks outside the
    s x s grid add 0 to the one all-reduce. Every rank returns the
    total."""
    dag = sorted_dag(g)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    s = math.isqrt(size)
    count = torch.zeros((), dtype=torch.int64, device=device)
    if rank < s * s:
        count = tc_count(block_edges_2d(dag, s, *divmod(rank, s),
                                        device=device))
    return int(all_reduce_sum(count, group))
