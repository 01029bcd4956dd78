"""The port's vertex partition and its rank tables against the JAX
package's: ``build_sharded_graph`` and ``pad_rows`` bit-equal, field by
field; ``ell_from_coo`` bucket-equal, with and without split rows; each
rank's forward and transpose tables (``build_shard_ell``) and their
packed weights equal to the JAX package's stacked layout's slice of that
shard, whose extra rows are padding. Then the offline partitioner
(``graph/partition.py``): every function bit-equal to the JAX package's
on tests/test_parallel.py::test_host_partitioners' graph, and the files
of ``write_partitions`` and of the CLI's ``partition`` route byte-equal
to the JAX package's (``partition.npz`` member by member: a zip records
each member's write time).
"""

import dataclasses
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import partition as jgp
from graphaibench_tpu.graph import transforms as jT
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.parallel import partition as jpart
from graphaibench_tpu.parallel import shard_ell as jse
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import partition as tgp
from graphaibench_tpu_torch.graph import transforms as tT
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.parallel import partition as tpart
from graphaibench_tpu_torch.parallel import shard_ell as tse

torch.set_num_threads(2)

# name -> (the graph in each package, its per-edge weights)
GRAPHS = {
    # power-law with self-loops: hubs, halo rows read by several rows
    "rmat9": lambda gen, T: T.add_selfloop(gen.rmat(9, 8, seed=3)),
    # tests/test_parallel.py::test_sharded_spmm_empty_shards: 10 vertices,
    # so at P = 3 under balance="vertex" the last block owns only padding
    "tiny": lambda gen, T: T.add_selfloop(gen.uniform_random(10, 20, seed=1)),
}


def _graphs(name):
    jg = GRAPHS[name](jgen, jT)
    tg = GRAPHS[name](tgen, tT)
    w = np.random.default_rng(0).random(jg.ne).astype(np.float32)
    return jg, tg, w


@pytest.mark.parametrize("balance", ["vertex", "edge"])
@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_graph_bit_equal(name, p, balance):
    jg, tg, w = _graphs(name)
    want = jpart.build_sharded_graph(jg, w, p, balance=balance)
    got = tpart.build_sharded_graph(tg, w, p, balance=balance)
    for f in dataclasses.fields(jpart.ShardedGraph):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    if name == "tiny" and p == 3 and balance == "vertex":
        assert not got.edge_valid[2].any()     # the empty shard
    rng = np.random.default_rng(1)
    for x in (rng.standard_normal((tg.nv, 3)).astype(np.float32),
              rng.integers(0, 5, tg.nv).astype(np.int32)):
        for perm in (None, got.perm):
            a = tpart.pad_rows(x, got.padded_nv, perm)
            b = jpart.pad_rows(x, want.padded_nv, perm)
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _random_coo(seed, n_rows, n_cols, ne, hub):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, ne)
    if hub:   # one row of degree 150 and one of 65: split into 64-wide pieces
        rows = np.concatenate([rows, np.full(150, 3), np.full(65, n_rows - 1)])
    cols = rng.integers(0, n_cols, len(rows))
    eids = rng.permutation(len(rows))
    return rows, cols, eids


@pytest.mark.parametrize("split", [None, 16])
@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_ell_from_coo_bucket_equal(seed, hub, split):
    rows, cols, eids = _random_coo(seed, 40, 70, 300, hub)
    sentinel = len(rows) + 5
    want = jdgm.ell_from_coo(rows, cols, eids, sentinel, split, as_numpy=True)
    got = tdgm.ell_from_coo(rows, cols, eids, sentinel, split)
    assert [w for w, *_ in got] == [b.width for b in want]
    assert (max(w for w, *_ in got) == (split or 64)) == (hub or split == 16)
    for (w, r, n, e), b in zip(got, want):
        for a, c in ((r, b.row_ids), (n, b.nbr), (e, b.edge_id)):
            assert np.array_equal(a, np.asarray(c)), w


@pytest.mark.parametrize("hub", [False, True])
def test_local_table_rows_and_columns(hub):
    """A rectangular table: its split and zero rows from the rows' edge
    counts, the pads at each row's tail, and no edge outside it."""
    rows, cols, eids = _random_coo(2, 40, 70, 300, hub)
    t = tdgm.local_table(rows, cols, eids, n_rows=40, n_cols=70,
                         sentinel=len(rows), device="cpu")
    deg = np.bincount(rows, minlength=40)
    assert (t.nv, t.n_cols, t.ne) == (40, 70, len(rows))
    assert np.array_equal(t.is_split.numpy(), (deg > 64).astype(np.uint8))
    assert np.array_equal(t.zero_rows.numpy(),
                          np.flatnonzero((deg > 64) | (deg == 0)))
    assert sum(int(b.valid.sum()) for b in t.ell) == len(rows)
    with pytest.raises(ValueError, match="outside"):
        tdgm.local_table(rows, cols, eids, n_rows=40, n_cols=69,
                         sentinel=len(rows), device="cpu")


def _jax_shard(buckets, p):
    return [(b.width, np.asarray(b.row_ids)[p], np.asarray(b.nbr)[p],
             np.asarray(b.edge_id)[p]) for b in buckets]


def _assert_same_buckets(got, want, sentinel, what):
    """The port's per-rank buckets against the JAX shard's slice of the
    stacked layout: equal rows, then padding rows only (row 0, nbr 0,
    the sentinel edge id); a width the rank lacks is padding throughout."""
    got = {b.width: b for b in got}
    for w, rid, nbr, eid in want:
        b = got.pop(w, None)
        r = 0 if b is None else b.rows
        if b is not None:
            assert np.array_equal(b.row_ids.numpy(), rid[:r]), (what, w)
            assert np.array_equal(b.nbr.numpy(), nbr[:r * w]), (what, w)
            assert np.array_equal(b.edge_id.numpy(), eid[:r * w]), (what, w)
        assert (rid[r:] == 0).all() and (nbr[r * w:] == 0).all()
        assert (eid[r * w:] == sentinel).all(), (what, w)
    assert not got, (what, sorted(got))


@pytest.mark.parametrize("part", ["all", "own", "halo"])
@pytest.mark.parametrize("balance", ["vertex", "edge"])
@pytest.mark.parametrize("p", [2, 3])
def test_rank_tables_equal_the_jax_shards(p, balance, part):
    jg, tg, w = _graphs("rmat9")
    sg = tpart.build_sharded_graph(tg, w, p, balance=balance)
    jsg = jpart.build_sharded_graph(jg, w, p, balance=balance)
    want = jse.build_shard_ell(jsg, part=part)
    wp = jse.pack_shard_values(want, jsg.edge_w)
    assert want.fwd_bounds is None and want.trans_bounds is None
    for r in range(p):
        se = tse.build_shard_ell(sg.shard(r), part=part)
        n_gather = {"all": sg.nv_pad + sg.h_max, "own": sg.nv_pad,
                    "halo": sg.h_max}[part]
        assert (se.fwd.nv, se.fwd.n_cols) == (sg.nv_pad, n_gather)
        assert (se.trans.nv, se.trans.n_cols) == (n_gather, sg.nv_pad)
        assert se.sentinel == se.fwd.ne == sg.e_max
        _assert_same_buckets(se.fwd.ell, _jax_shard(want.fwd, r), sg.e_max,
                             f"rank {r} fwd")
        _assert_same_buckets(se.trans.ell, _jax_shard(want.trans, r),
                             sg.e_max, f"rank {r} trans")
        packed = tse.pack_shard_values(se, torch.from_numpy(sg.edge_w[r]))
        for tab, mine, theirs in ((se.fwd, packed.fwd, wp.fwd),
                                  (se.trans, packed.t, wp.t)):
            jw = {b.width: np.asarray(v)[r]
                  for b, v in zip(want.fwd if tab is se.fwd else want.trans,
                                  theirs)}
            for b, v in zip(tab.ell, mine):
                n = b.rows * b.width
                assert np.array_equal(v.numpy(), jw[b.width][:n])


# ---- the offline partitioner ---------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csr_equal(a, b, what):
    for f in ("row_ptr", "col_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (what, f)
    assert a.nv == b.nv and a.ne == b.ne, what


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def _ur300(gen):
    return gen.uniform_random(300, 900, seed=11)


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_edgecut_partitions_bit_equal(parts):
    jg, tg = _ur300(jgen), _ur300(tgen)
    _same(tgp.edgecut_partition_1d(tg, parts),
          jgp.edgecut_partition_1d(jg, parts), "bounds")
    got = tgp.edgecut_induced_partition_1d(tg, parts)
    want = jgp.edgecut_induced_partition_1d(jg, parts)
    assert len(got) == len(want) == parts
    for i, (a, b) in enumerate(zip(got, want)):
        _csr_equal(a.subgraph, b.subgraph, i)
        _same(a.local_to_global, b.local_to_global, i)
        assert (a.num_masters, a.global_range) == (
            b.num_masters, b.global_range)


@pytest.mark.parametrize("width", [64, 1000])
def test_csr_segmenting_bit_equal(width):
    got = tgp.csr_segmenting(_ur300(tgen), width)
    want = jgp.csr_segmenting(_ur300(jgen), width)
    assert got.range_width == want.range_width
    assert len(got.segments) == len(want.segments)
    for k, (a, b) in enumerate(zip(got.segments, want.segments)):
        _csr_equal(a, b, k)
        _same(got.edge_perm[k], want.edge_perm[k], k)


def test_partition_2d_and_schedulers_bit_equal():
    jg, tg = _ur300(jgen), _ur300(tgen)
    clusters = np.random.default_rng(3).integers(0, 3, jg.nv)
    got, want = tgp.partition_2d(tg, clusters, 3), jgp.partition_2d(
        jg, clusters, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            _same(a, b, k)
    for name, args in (("schedule_round_robin", (jg.ne, 3, 16)),
                       ("schedule_vertex_chunking", (None, 3)),
                       ("schedule_least_first", (None, 3, 16))):
        t_args = tuple(tg if a is None else a for a in args)
        j_args = tuple(jg if a is None else a for a in args)
        a, b = getattr(tgp, name)(*t_args), getattr(jgp, name)(*j_args)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            _same(x, y, name)


def _files_equal(a_dir, b_dir):
    """Every file of two partition directories byte-equal; the npz's
    members byte-equal."""
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and "partition.npz" in names
    for name in names:
        a, b = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if name.endswith(".npz"):
            with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
                assert za.namelist() == zb.namelist()
                for m in za.namelist():
                    assert za.read(m) == zb.read(m), (name, m)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_write_and_read_partitions(tmp_path):
    jg, tg = _ur300(jgen), _ur300(tgen)
    parts = tgp.write_partitions(tg, 3, str(tmp_path / "t"))
    jgp.write_partitions(jg, 3, str(tmp_path / "j"))
    for i, p in enumerate(parts):
        _files_equal(tmp_path / f"t-part{i}", tmp_path / f"j-part{i}")
        q = tgp.read_partition(str(tmp_path / "t"), i)
        _csr_equal(q.subgraph, p.subgraph, i)
        _same(q.local_to_global, p.local_to_global, i)
        assert (q.num_masters, q.global_range) == (p.num_masters,
                                                   p.global_range)


def test_cli_partition_files_equal_jax(tmp_path):
    from graphaibench_tpu_torch.graph.io import Meta, save_graph

    g = tgen.rmat(9, 8, seed=0)
    ds = str(tmp_path / "rmat9")
    save_graph(g, ds, meta=Meta(nv=g.nv, ne=g.ne))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    outs = {}
    for pkg in ("graphaibench_tpu_torch", "graphaibench_tpu"):
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", "partition", ds, "3",
             str(tmp_path / pkg / "p")], cwd=REPO, capture_output=True,
            text=True, timeout=120, env=env)
        assert r.returncode == 0, r.stderr
        outs[pkg] = r.stdout
    assert outs["graphaibench_tpu_torch"] == outs["graphaibench_tpu"]
    assert "subgraph[2]: masters" in outs["graphaibench_tpu"]
    for i in range(3):
        _files_equal(tmp_path / "graphaibench_tpu_torch" / f"p-part{i}",
                     tmp_path / "graphaibench_tpu" / f"p-part{i}")
