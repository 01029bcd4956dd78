"""Device-resident graph for the port's sparse ops.

Counterpart of ``graphaibench_tpu/ops/device_graph.py``: the same
adjacency in COO/CSR form plus degree-bucketed ELL, held as torch tensors
on an explicit ``device``.

  * COO (edge_src / col_idx, CSR-ordered) — for the plain COO and dense
    SpMM strategies and per-edge ops.
  * Degree-bucketed ELL — rows grouped by pow2 degree up to width 64,
    heavier rows split into 64-wide virtual rows that target the same
    output row (consumers add the pieces of such a row, never store
    them). Pad slots have nbr 0 and edge_id ne, the sentinel that
    gathers a zero weight. Slot arrays are flat (R*W,), row r's slots at
    [r*W, (r+1)*W), as the reference stores them.
  * Beside the ELL layout, two arrays derived from the degrees tell the
    kernels how to write a row: ``is_split`` (the row has several
    virtual rows, so its pieces are combined) and ``zero_rows`` (the rows
    a kernel does not store to: degree 0, which has no virtual row, and
    split rows, whose adds need a zero to start from). Each bucket also
    carries ``valid``, the number of real slots of each virtual row: the
    pads sit at the row's tail, so a kernel that cannot neutralise a pad
    with a zero weight (the GAT passes: ``exp`` of a pad is not 0) loops
    over the first ``valid`` slots only.

A table may be rectangular: ``nv`` output rows gather from ``n_cols``
rows (``n_cols`` defaults to ``nv``). The sharded trainer's per-rank
tables are such (``local_table``): a shard's own rows gather from its own
rows and its halo, and a table of its own, the transpose, carries the
adjoint. Their edge ids index the shard's slot space of ``ne`` slots, and
``ne`` is the pad slots' sentinel there too.

The transpose permutation (host-built once) turns the SpMM adjoint into
the same bucket pass on transpose-permuted weights. A caller that needs
neither (``with_transpose=False``) or no buckets (``with_ell=False``: the
analytics solvers' push route on directed inputs) leaves them out, as the
JAX package's analytics CLI does.

The host ELL packing is ``native.ell_pack`` (one native pass), with the
numpy route (``_virtual_rows``, ``_pack_buckets``) for hosts without
``g++``, tested bit-equal against the native packer.

Index arrays are int32, as in the reference; the kernel widens to 64 bits
for addresses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graphaibench_tpu_torch import native
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.graph.csr import CSRGraph


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """Rows of (padded) degree exactly ``width``."""

    row_ids: torch.Tensor   # (R,) int32 — output row of each virtual row
    nbr: torch.Tensor       # (R*W,) int32, padded with 0
    edge_id: torch.Tensor   # (R*W,) int32, padded with ne (sentinel)
    width: int
    valid: torch.Tensor     # (R,) int32 — real slots of each virtual row

    @property
    def rows(self) -> int:
        return self.row_ids.shape[0]


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Static-topology device graph. Edge weights are supplied separately
    at call sites, so one topology serves any per-edge weighting."""

    row_ptr: torch.Tensor               # (N+1,) int32
    col_idx: torch.Tensor               # (E,) int32 — CSR destination ids
    edge_src: torch.Tensor              # (E,) int32 — CSR-ordered source ids
    deg: torch.Tensor                   # (N,) int32
    # edge k of G^T is edge trans_perm[k] of G; None when not built
    trans_perm: Optional[torch.Tensor]  # (E,) int32
    ell: tuple                          # tuple[EllBucket, ...] (empty if ne == 0
                                        # or built without ELL)
    is_split: torch.Tensor              # (N,) uint8 — 1 where deg > ELL_SPLIT
    zero_rows: torch.Tensor             # (K,) int64 — ids with deg 0 or deg > ELL_SPLIT
    nv: int
    ne: int
    # rows the neighbour ids index (the gathered tables'); None: nv
    n_cols: Optional[int] = None
    # what a kernel's wrapper derives from the graph once and keeps for
    # its later launches (its per-bucket pointer table), by wrapper name;
    # a copy made with dataclasses.replace starts with none
    launch_tables: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self.n_cols is None:
            object.__setattr__(self, "n_cols", self.nv)

    @property
    def has_ell_layout(self) -> bool:
        return bool(self.ell)


class SlotWeights(tuple):
    """The per-bucket slot weights of one weight view: a tuple, indexed
    and zipped like any other, of a class of its own so that
    ``ops/ell_spmm.py`` can keep on it the launch table it builds (and the
    validation it does) at the view's first SpMM."""

    launch_table = None


@dataclasses.dataclass(frozen=True)
class PackedEdgeW:
    """Per-bucket pre-gathered values of STATIC edge weights (GCN norms,
    SAGE means): ``fwd[i] == w_pad[ell[i].edge_id]`` and ``t[i]`` the same
    for the transpose-permuted weights (the SpMM adjoint), so no SpMM
    gathers a weight by edge id at run time. ``raw`` keeps the (ne,)
    array for the COO/dense strategies and the weight gradient."""

    raw: torch.Tensor
    fwd: SlotWeights
    t: SlotWeights


def pack_edge_values(g: DeviceGraph, w: torch.Tensor) -> PackedEdgeW:
    """One-time per-bucket pre-gather of static per-edge values."""
    return PackedEdgeW(raw=w, fwd=pack_slot_values(g, w),
                       t=pack_slot_values(g, w[g.trans_perm]))


def pack_slot_values(g: DeviceGraph, w: torch.Tensor) -> SlotWeights:
    """Per-bucket pre-gather of static values ``w`` of the graph's edge
    ids ((ne,): a pad slot's sentinel id gathers 0)."""
    w_pad = torch.cat([w, w.new_zeros(1)])
    return SlotWeights(w_pad[b.edge_id] for b in g.ell)


# Width grid and heavy-row split of the reference layout
# (graphaibench_tpu/ops/device_graph.py, _WIDTH_GRID / ELL_SPLIT): every
# row wider than 64 becomes 64-wide virtual rows, so five buckets cover
# any degree distribution.
_WIDTH_GRID = (4, 8, 16, 32, 64)
ELL_SPLIT = 64


def _widths_for_split(split: int) -> list[int]:
    return ([w for w in _WIDTH_GRID if w < split] + [split]
            if split >= _WIDTH_GRID[0] else [split])


def _virtual_rows(targets, counts, starts, split):
    """Split (target, start, count) row descriptors into <=split-wide
    virtual rows. Returns (vr_target, vr_start, vr_len)."""
    counts = counts.astype(np.int64)
    nchunks = np.maximum((counts + split - 1) // split, 1)
    vt = np.repeat(targets, nchunks)
    vstart = np.repeat(starts.astype(np.int64), nchunks)
    first = np.repeat(np.cumsum(nchunks) - nchunks, nchunks)
    k = np.arange(len(vt), dtype=np.int64) - first
    vs = vstart + k * split
    vl = np.minimum(np.repeat(counts, nchunks) - k * split, split)
    keep = vl > 0
    return vt[keep], vs[keep], vl[keep]


def _pack_buckets(vr_t, vr_s, vr_l, col, edge_ids, ne, widths) -> list:
    """Width-bucket virtual rows into flat padded slot arrays. Returns
    ``[(width, row_ids, nbr, edge_id), ...]`` (numpy), empty widths
    omitted — the format of ``native.ell_pack``."""
    out = []
    for wi, w in enumerate(widths):
        lo = widths[wi - 1] if wi > 0 else 0
        sel = (vr_l > lo) & (vr_l <= w)
        if not sel.any():
            continue
        rows, starts, lens = vr_t[sel], vr_s[sel], vr_l[sel]
        offs = np.arange(w, dtype=np.int64)[None, :]
        in_row = offs < lens[:, None]
        pos_c = np.where(in_row, starts[:, None] + offs, 0)
        nbr = np.where(in_row, col[pos_c], 0).astype(np.int32)
        raw_eid = pos_c if edge_ids is None else edge_ids[pos_c]
        eid = np.where(in_row, raw_eid, ne).astype(np.int32)
        out.append((w, rows.astype(np.int32), nbr.reshape(-1),
                    eid.reshape(-1)))
    return out


def _pack_rows_numpy(targets, starts, counts, col, eid, sentinel, widths,
                     split) -> list:
    """The numpy packing path, bit-identical to ``native.ell_pack``."""
    vr_t, vr_s, vr_l = _virtual_rows(np.asarray(targets, np.int32),
                                     np.asarray(counts),
                                     np.asarray(starts), split)
    return _pack_buckets(vr_t, vr_s, vr_l, np.asarray(col), eid, sentinel,
                         widths)


def _pack_rows(targets, starts, counts, col, eid, sentinel, widths,
               split) -> list:
    """One native pass when ``g++`` is available, numpy otherwise."""
    res = native.ell_pack(targets, starts, counts, col, eid, sentinel,
                          widths, split)
    if res is not None:
        return res
    return _pack_rows_numpy(targets, starts, counts, col, eid, sentinel,
                            widths, split)


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _valid_slots(edge_id: np.ndarray, width: int, sentinel: int) -> np.ndarray:
    """Real slots per virtual row of one bucket; raises unless every pad
    sits behind every real slot of its row."""
    real = edge_id.reshape(-1, width) != sentinel
    valid = real.sum(1).astype(np.int32)
    if not np.array_equal(real, np.arange(width)[None, :] < valid[:, None]):
        raise ValueError(f"bucket of width {width}: a pad slot precedes a "
                         "real slot of its row")
    return valid


def build_ell_buckets(g: CSRGraph, *, device,
                      split: int = ELL_SPLIT) -> list[EllBucket]:
    """Degree-bucketed ELL packing with heavy-row splitting, on ``device``.

    Rows of degree 0 are skipped (their aggregation output is zero).
    Rows wider than ``split`` become several virtual rows that target the
    same output row: consumers MUST accumulate, not store."""
    if g.nv == 0 or g.ne == 0:
        return []
    res = _pack_rows(np.arange(g.nv, dtype=np.int32), g.row_ptr[:-1],
                     g.degrees().astype(np.int64), g.col_idx, None, g.ne,
                     _widths_for_split(split), split)
    return [EllBucket(row_ids=_to(r, device), nbr=_to(n, device),
                      edge_id=_to(e, device), width=int(w),
                      valid=_to(_valid_slots(e, int(w), g.ne), device))
            for (w, r, n, e) in res]


def to_device_graph(g: CSRGraph, *, device, with_transpose: bool = True,
                    with_ell: bool = True) -> DeviceGraph:
    """One-time host -> device transfer of the layouts of ``g``: every one
    by default; without the transpose permutation (``trans_perm`` None) or
    without the ELL buckets (``ell`` empty) on request."""
    if g.ne >= 2**31:
        raise ValueError("edge count must fit int32")
    src, dst = g.coo()
    deg = g.degrees()
    split = deg > ELL_SPLIT
    return DeviceGraph(
        row_ptr=_to(g.row_ptr, device),
        col_idx=_to(dst, device),
        edge_src=_to(src, device),
        deg=_to(deg, device),
        trans_perm=(_to(T.transpose_edge_permutation(g), device)
                    if with_transpose else None),
        ell=tuple(build_ell_buckets(g, device=device)) if with_ell else (),
        is_split=torch.from_numpy(split.astype(np.uint8)).to(device),
        zero_rows=torch.from_numpy(
            np.flatnonzero(split | (deg == 0)).astype(np.int64)).to(device),
        nv=g.nv,
        ne=g.ne,
    )


def coo_device_graph(edge_src, col_idx, trans_perm, deg, *, nv: int,
                     device) -> DeviceGraph:
    """A device graph of COO arrays only, from host arrays of one padded
    sampled subgraph: no ELL buckets, so it takes the ``coo`` or ``dense``
    SpMM strategy and the plain per-edge ops. ``row_ptr`` is not read on
    those paths and stays empty."""
    none = torch.zeros(0, dtype=torch.int32, device=device)
    return DeviceGraph(
        row_ptr=none,
        col_idx=_to(col_idx, device),
        edge_src=_to(edge_src, device),
        deg=_to(deg, device),
        trans_perm=_to(trans_perm, device),
        ell=(),
        is_split=torch.zeros(nv, dtype=torch.uint8, device=device),
        zero_rows=torch.zeros(0, dtype=torch.int64, device=device),
        nv=nv,
        ne=len(col_idx),
    )


def _run_lengths(sorted_keys):
    """(uniq, starts, counts) of an already-sorted key array."""
    if len(sorted_keys) == 0:
        z = np.empty(0, np.int64)
        return sorted_keys, z, z
    idx = np.flatnonzero(sorted_keys[1:] != sorted_keys[:-1]) + 1
    starts = np.concatenate([[0], idx])
    counts = np.diff(np.concatenate([starts, [len(sorted_keys)]]))
    return sorted_keys[starts], starts, counts


def ell_from_coo(rows, cols, eids, sentinel: int,
                 split: Optional[int] = None) -> list:
    """Pack a COO edge list into degree-bucketed ELL with heavy-row
    splitting, as ``graphaibench_tpu/ops/device_graph.py::ell_from_coo``:
    ``rows`` are stable-sorted (edges keep their order within a row),
    ``eids[k]`` is edge k's index into the consumer's per-edge values and
    ``sentinel`` the pad slots' id. Returns ``[(width, row_ids, nbr,
    edge_id), ...]`` (numpy), the format of ``native.ell_pack``."""
    split = split or ELL_SPLIT
    if len(rows) == 0:
        return []
    r_in = np.asarray(rows)
    order = native.stable_key_sort(r_in.astype(np.int32), int(r_in.max()) + 1)
    if order is None:
        order = np.argsort(r_in, kind="stable")
    r = r_in[order]
    uniq, starts, counts = _run_lengths(r)
    return _pack_rows(uniq.astype(np.int32), starts, counts,
                      np.asarray(cols)[order], np.asarray(eids)[order],
                      sentinel, _widths_for_split(split), split)


def local_table(rows, cols, eids, *, n_rows: int, n_cols: int,
                sentinel: int, device) -> DeviceGraph:
    """A rectangular table on ``device``: the edges (rows[k] -> cols[k])
    of ``n_rows`` output rows over ``n_cols`` gathered rows, packed by
    ``ell_from_coo``, with ``is_split`` and ``zero_rows`` from the rows'
    edge counts. Edge ids index a slot space of ``sentinel`` slots (the
    table's ``ne``); only the ELL layout is built, so the table serves the
    bucket passes (K1, the GAT passes) and nothing that reads COO."""
    rows = np.asarray(rows, np.int64)
    deg = np.bincount(rows, minlength=n_rows)
    if len(deg) != n_rows or (len(cols) and (np.min(cols) < 0
                                             or np.max(cols) >= n_cols)):
        raise ValueError("an edge lies outside the table's rows or columns")
    heavy = deg > ELL_SPLIT
    none = torch.zeros(0, dtype=torch.int32, device=device)
    ell = tuple(
        EllBucket(row_ids=_to(r, device), nbr=_to(n, device),
                  edge_id=_to(e, device), width=int(w),
                  valid=_to(_valid_slots(e, int(w), sentinel), device))
        for (w, r, n, e) in ell_from_coo(rows, cols, eids, sentinel))
    return DeviceGraph(
        row_ptr=none, col_idx=none, edge_src=none, deg=_to(deg, device),
        trans_perm=None, ell=ell,
        is_split=torch.from_numpy(heavy.astype(np.uint8)).to(device),
        zero_rows=torch.from_numpy(
            np.flatnonzero(heavy | (deg == 0)).astype(np.int64)).to(device),
        nv=n_rows, ne=sentinel, n_cols=n_cols)
