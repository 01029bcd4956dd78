"""The port's triangle counting and BFS on a CGR stream
(``graphaibench_tpu_torch/analytics/tc_stream.py``: blocks decoded by K12's
``cgr_residual``, block pairs counted by K9's ``tc_count`` through
``ops/tc_count.py::edges_between``), the compressed-prefix routes of
``run_benchmark``, held against the JAX package's ``tc_stream.py`` and the
port's uncompressed solvers on the CPU.

Counts and depths are integers and must be equal. ``block_bytes`` is small
enough that every graph here splits into several blocks.
"""

import numpy as np
import pytest
import torch

from graphaibench_tpu.analytics import tc_stream as JS
from graphaibench_tpu.compress import cgr as jcgr
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch.analytics import bfs, run_benchmark, triangle_count
from graphaibench_tpu_torch.analytics import tc_stream as TS
from graphaibench_tpu_torch.analytics import verifiers as TV
from graphaibench_tpu_torch.compress import cgr as tcgr
from graphaibench_tpu_torch.compress import cgr_device as CD
from graphaibench_tpu_torch.compress import cli as tccli
from graphaibench_tpu_torch.compress import hybrid as thybrid
from graphaibench_tpu_torch.compress import vbyte as tvbyte
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import cgr_decode as K12
from graphaibench_tpu_torch.ops import tc_count as K9
from graphaibench_tpu_torch.ops.device_graph import to_device_graph
from test_torch_tc import check_task_layout, emulate_kernel

torch.set_num_threads(2)

BLOCK_BYTES = 1 << 14          # 4,096 edges a block: the floor
GRAPHS = {
    "rmat10": lambda gen, tr, csr: tr.sort_and_clean(gen.rmat(10, 8, seed=2)),
    "uniform": lambda gen, tr, csr: gen.uniform_random(600, 6000, seed=5),
    "rmat11": lambda gen, tr, csr: tr.sort_and_clean(gen.rmat(11, 8, seed=3)),
    "rmat12": lambda gen, tr, csr: tr.sort_and_clean(gen.rmat(12, 8, seed=4)),
    "grid": lambda gen, tr, csr: gen.grid2d(70),
    "edgeless": lambda gen, tr, csr: csr.from_edges([], [], 9),
}
_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        t = GRAPHS[name](tgen, T, tcsr)
        j = GRAPHS[name](jgen, JT, jcsr)
        assert np.array_equal(t.col_idx, j.col_idx)
        _CACHE[name] = (t, j, tcgr.encode_graph(t), jcgr.encode_graph(j))
    return _CACHE[name]


@pytest.mark.parametrize("name", ["rmat10"])
def test_streaming_count_equals_jax(name):
    g, _, cg, jc = _pair(name)
    n, stats = TS.triangle_count_streaming(cg, block_bytes=BLOCK_BYTES,
                                           device="cpu")
    jn, jstats = JS.triangle_count_streaming(jc, block_bytes=BLOCK_BYTES)
    assert n == jn == triangle_count(g, device="cpu")
    assert stats["blocks"] >= 3 and stats["blocks"] == jstats["blocks"]
    assert stats["pairs"] >= stats["blocks"]


@pytest.mark.parametrize("name", ["rmat10", "uniform", "rmat11", "grid",
                                  "edgeless"])
def test_streaming_count_equals_the_uncompressed_count(name):
    g, _, cg, _ = _pair(name)
    n, stats = TS.triangle_count_streaming(cg, block_bytes=BLOCK_BYTES,
                                           device="cpu")
    assert n == triangle_count(g, device="cpu")
    assert n == TV.triangle_count_serial(T.orientation(g))
    assert stats["nv"] == g.nv and stats["ne"] == g.ne


def test_streaming_count_with_other_configs():
    g, *_ = _pair("rmat11")
    want = triangle_count(g, device="cpu")
    for kw in (dict(zeta_k=3, alignment="word"), dict(add_degree=True),
               dict(res_seg_len=64, zeta_k=1)):
        cg = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
        n, _ = TS.triangle_count_streaming(cg, block_bytes=1 << 15,
                                           device="cpu")
        assert n == want, kw


@pytest.mark.parametrize("name", ["rmat10"])
def test_streaming_bfs_equals_jax(name):
    g, _, cg, jc = _pair(name)
    got = TS.bfs_streaming(cg, 0, block_bytes=BLOCK_BYTES, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), JS.bfs_streaming(
        jc, 0, block_bytes=BLOCK_BYTES))


@pytest.mark.parametrize("name,source", [("rmat10", 0), ("uniform", 5),
                                         ("rmat11", 17), ("grid", 0)])
def test_streaming_bfs_equals_bfs(name, source):
    g, _, cg, _ = _pair(name)
    got = TS.bfs_streaming(cg, source, block_bytes=BLOCK_BYTES,
                           device="cpu").numpy()
    dg = to_device_graph(g, device="cpu", with_transpose=False)
    assert np.array_equal(got, bfs(dg, source).numpy())
    assert np.array_equal(got, TV.bfs_serial(g, source))


def test_interval_and_unary_streams_raise_in_both():
    g, jg, _, _ = _pair("rmat10")
    for kw in (dict(use_interval=True), dict(res_seg_len=0)):
        t = tcgr.encode_graph(g, tcgr.CgrConfig(**kw))
        j = jcgr.encode_graph(jg, jcgr.CgrConfig(**kw))
        with pytest.raises(CD.StreamRefused, match="streaming"):
            TS.triangle_count_streaming(t, device="cpu")
        with pytest.raises(CD.StreamRefused, match="streaming"):
            TS.bfs_streaming(t, 0, device="cpu")
        with pytest.raises(ValueError):
            JS.triangle_count_streaming(j)


def test_oversized_segment_raises_on_the_block_decode():
    src = np.asarray([0, 0, 0, 1 << 9, (1 << 9) + (1 << 8), 1 << 10])
    dst = np.r_[src[3:], np.zeros(3, np.int64)]
    g = T.sort_and_clean(tcsr.from_edges(src, dst, 1 << 11))
    cg = tcgr.encode_graph(g, tcgr.CgrConfig(res_seg_len=16, zeta_k=1))
    with pytest.raises(CD.StreamRefused, match="oversized|parse mismatch"):
        TS.triangle_count_streaming(cg, device="cpu")


def test_block_bounds_cover_the_vertices_in_order():
    g, _, cg, _ = _pair("rmat11")
    st = TS.open_cgr_stream(cg, device="cpu")
    bounds = TS.block_bounds(st, BLOCK_BYTES)
    assert bounds[0][0] == 0 and bounds[-1][1] == g.nv
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # a block ends at the first vertex that takes it to the target
    target = max(BLOCK_BYTES // TS.BLOCK_EDGE_BYTES, 1 << 12)
    assert all(g.row_ptr[hi - 1] - g.row_ptr[lo] < target
               for lo, hi in bounds)
    assert all(g.row_ptr[hi] - g.row_ptr[lo] >= target
               for lo, hi in bounds[:-1])
    lo, hi = bounds[1]
    col = TS.decode_block(st, lo, hi)
    assert np.array_equal(col.numpy(),
                          g.col_idx[g.row_ptr[lo]:g.row_ptr[hi]])


def test_edges_between_lays_out_the_kernels_groups():
    """A block pair's layout, built on the device, against the layout's
    invariants (every edge with both rows non-empty once, tasks of one
    source by class); the pair's count, the kernel's arithmetic emulated
    on it, equals the count of its edges over the global ids."""
    g, _, cg, _ = _pair("rmat11")
    st = TS.open_cgr_stream(cg, device="cpu")
    (ilo, ihi), (jlo, jhi) = TS.block_bounds(st, BLOCK_BYTES)[:2]
    rp_i, col_i, u_i = TS.dag_block(st, ilo, ihi)
    rp_j, col_j, _ = TS.dag_block(st, jlo, jhi)
    sel = (col_i >= jlo) & (col_i < jhi)
    n_i = ihi - ilo
    rp = torch.cat([rp_i, rp_j[1:] + rp_i[-1]])
    col = torch.cat([col_i, col_j])
    src, dst = u_i[sel], n_i + col_i[sel].long() - jlo
    got = K9.edges_between(rp, col, src, dst, id_bound=g.nv)
    s_np, d_np = src.numpy(), dst.numpy()
    check_task_layout(got, s_np, d_np)
    assert got.sentinel == g.nv + 1 and got.nv == n_i + jhi - jlo
    rows = [set(col[rp[r]:rp[r + 1]].tolist()) for r in range(got.nv)]
    want = sum(len(rows[a] & rows[b]) for a, b in zip(s_np, d_np))
    assert want > 0 and int(K9.tc_count(got)) == want
    assert emulate_kernel(got) == want


def _save(tmp_path, obj, name):
    prefix = str(tmp_path / name / "g")
    tccli.save_compressed(obj, prefix)
    return prefix


def test_run_benchmark_on_a_cgr_prefix(tmp_path, capsys, monkeypatch):
    g, _, cg, _ = _pair("rmat10")
    prefix = _save(tmp_path, cg, "cgr")
    for kernel in ("tc", "bfs", "cc"):
        assert run_benchmark(kernel, prefix, ["0"], device="cpu") == 0
        out = capsys.readouterr().out.splitlines()
        assert "decoded cgr on device cpu" in out
        assert f"|V| {g.nv} |E| {g.ne}" in out
        assert "device = cpu" in out and "Correct" in out
    monkeypatch.setenv("GAB_TC_STREAM", "1")
    assert run_benchmark("tc", prefix, [], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    want = triangle_count(g, device="cpu")
    assert f"total_num_triangles = {want} (streaming, 1 blocks)" in out
    assert "Correct" in out


def test_run_benchmark_decodes_on_the_host_where_the_device_refuses(
        tmp_path, capsys, monkeypatch):
    g, *_ = _pair("rmat10")
    prefix = _save(tmp_path, tcgr.encode_graph(
        g, tcgr.CgrConfig(res_seg_len=0)), "unary")
    assert run_benchmark("bfs", prefix, ["0"], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("decoded on host (device CGR decode: "
                               "unsegmented") for line in out)
    assert "Correct" in out
    # the streaming route refuses an interval stream and counts decoded
    monkeypatch.setenv("GAB_TC_STREAM", "1")
    prefix = _save(tmp_path, tcgr.encode_graph(
        g, tcgr.CgrConfig(use_interval=True)), "itv")
    assert run_benchmark("tc", prefix, [], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("streaming unsupported") for line in out)
    assert "decoded cgr on device cpu" in out and "Correct" in out


def test_run_benchmark_raises_a_wrappers_fault(tmp_path, monkeypatch):
    """Only the stream shapes the device route refuses go to the host: a
    K12 wrapper's ValueError for its operands (here a stream of the wrong
    type) raises out of run_benchmark, on both routes."""
    g, _, cg, _ = _pair("rmat10")
    prefix = _save(tmp_path, cg, "cgr")
    stream_tensor = K12.stream_tensor
    monkeypatch.setattr(K12, "stream_tensor", lambda data, device:
                        stream_tensor(data, device).to(torch.int16))
    with pytest.raises(ValueError, match="uint8") as e:
        run_benchmark("bfs", prefix, ["0"], device="cpu")
    assert not isinstance(e.value, CD.StreamRefused)
    monkeypatch.setenv("GAB_TC_STREAM", "1")
    with pytest.raises(ValueError, match="uint8") as e:
        run_benchmark("tc", prefix, [], device="cpu")
    assert not isinstance(e.value, CD.StreamRefused)


@pytest.mark.parametrize("scheme", ["streamvbyte", "varintgb", "hybrid"])
def test_run_benchmark_decodes_the_other_schemes(scheme, tmp_path, capsys):
    """StreamVByte, VarintGB and StreamVByte-hybrid prefixes decode through
    the device route (K11), on the CPU here, and count Correct."""
    g, *_ = _pair("rmat10")
    obj = (thybrid.encode_graph(g) if scheme == "hybrid"
           else tvbyte.encode_graph(g, scheme))
    prefix = _save(tmp_path, obj, scheme)
    assert run_benchmark("tc", prefix, [], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert f"decoded {scheme} on device cpu" in out
    assert f"|V| {g.nv} |E| {g.ne}" in out
    assert f"total_num_triangles = {triangle_count(g, device='cpu')}" in out
    assert "Correct" in out


def test_run_benchmark_decodes_a_varintgb_hybrid_on_the_host(tmp_path,
                                                             capsys):
    """The device route takes StreamVByte chunks only: a hybrid of VarintGB
    chunks is refused (StreamRefused) and decoded on the host, as JAX's
    route does."""
    g, *_ = _pair("rmat10")
    prefix = _save(tmp_path, thybrid.encode_graph(g, vbyte_scheme="varintgb"),
                   "hybrid_vgb")
    assert run_benchmark("bfs", prefix, ["0"], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert "decoded on host (device hybrid decode: varintgb chunks (the " \
        "device decode takes streamvbyte chunks))" in out
    assert "Correct" in out


# ---- what the streamed count holds on the device --------------------------

def test_streaming_count_in_eight_blocks_or_more_equals_jax():
    """At a block_bytes that cuts rmat12 into at least 8 blocks, the count
    equals JAX's streamed count and the uncompressed count; every block
    pair with a DAG edge between them is counted once."""
    g, jg, cg, jc = _pair("rmat12")
    want = triangle_count(g, device="cpu")
    n, stats = TS.triangle_count_streaming(cg, block_bytes=1 << 10,
                                           device="cpu")
    assert stats["blocks"] >= 8
    # JAX's count in its own (default) blocks: it compiles per block shape
    jn, _ = JS.triangle_count_streaming(jc)
    assert n == jn == want == TV.triangle_count_serial(T.orientation(g))
    assert stats["blocks"] <= stats["pairs"] <= stats["blocks"] ** 2


def test_dag_block_and_rows_are_int32():
    g, _, cg, _ = _pair("rmat11")
    st = TS.open_cgr_stream(cg, device="cpu")
    assert st.lanes.dtype == np.int32 and st.lanes.shape[0] == 4
    # on the device: the stream and O(nv) beside it
    assert not any(isinstance(v, torch.Tensor) and v.numel() > g.nv + 1
                   for k, v in vars(st).items() if k != "stream")
    (lo, hi), _ = TS.block_bounds(st, BLOCK_BYTES)[:2]
    rows = TS._rows(st, lo, hi)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(
        rows.numpy(), np.repeat(np.arange(hi - lo), g.degrees()[lo:hi]))
    rp, col, u = TS.dag_block(st, lo, hi)
    assert rp.dtype == col.dtype == u.dtype == torch.int32
    # the block's DAG rows are the orientation's
    dag = T.orientation(g)
    np.testing.assert_array_equal(rp.numpy(), dag.row_ptr[lo:hi + 1]
                                  - dag.row_ptr[lo])
    np.testing.assert_array_equal(
        col.numpy(), dag.col_idx[dag.row_ptr[lo]:dag.row_ptr[hi]])
    np.testing.assert_array_equal(u.numpy(), np.repeat(
        np.arange(hi - lo), np.diff(dag.row_ptr[lo:hi + 1])))


def test_block_bytes_is_a_working_set_budget():
    """The stated difference from JAX: ``block_bytes`` bounds a block pair's
    device work at BLOCK_EDGE_BYTES (32) a block edge, so a block holds
    block_bytes / 32 edges where JAX's holds block_bytes / 8, and the
    default is 16 MiB, where JAX's is 32 MiB (524,288 edges a block against
    4,194,304)."""
    import inspect

    assert TS.BLOCK_EDGE_BYTES == 32
    assert TS.DEFAULT_BLOCK_BYTES == 16 << 20
    jdefault = inspect.signature(
        JS.triangle_count_streaming).parameters["block_bytes"].default
    assert jdefault == 32 << 20
    g, _, cg, jc = _pair("rmat11")
    st = TS.open_cgr_stream(cg, device="cpu")
    budget = 1 << 18                 # 8,192 port edges, 32,768 JAX edges
    bounds = TS.block_bounds(st, budget)
    sizes = [g.row_ptr[hi] - g.row_ptr[lo] for lo, hi in bounds]
    assert all(s >= budget // 32 for s in sizes[:-1])
    assert all(g.row_ptr[hi - 1] - g.row_ptr[lo] < budget // 32
               for lo, hi in bounds)
    _, stats = TS.triangle_count_streaming(cg, block_bytes=budget,
                                           device="cpu")
    _, jstats = JS.triangle_count_streaming(jc, block_bytes=budget)
    assert stats["blocks"] == len(bounds) >= 3 > jstats["blocks"]


def test_block_tables_are_residual_tables_of_the_blocks_lanes(monkeypatch):
    """Each block's cgr_residual tables are built once, on the host, from
    its own lanes' counts (``K12.residual_tables``, relative to its first
    lane), and the block
    decode passes them with its lanes: the ids are the graph's, and a
    second pass builds nothing new."""
    g, _, cg, _ = _pair("rmat11")
    st = TS.open_cgr_stream(cg, device="cpu")
    bounds = TS.block_bounds(st, BLOCK_BYTES)
    assert len(bounds) >= 3
    seen = []
    real = K12.cgr_residual

    def spy(*args, tiles=None, order=None):
        seen.append((tiles.clone(), order.clone()))
        return real(*args, tiles=tiles, order=order)

    monkeypatch.setattr(K12, "cgr_residual", spy)
    for vlo, vhi in bounds:
        col = TS.decode_block(st, vlo, vhi)
        lo, hi = g.row_ptr[vlo], g.row_ptr[vhi]
        np.testing.assert_array_equal(col.numpy(), g.col_idx[lo:hi])
        l0, l1 = int(st.lane_start[vlo]), int(st.lane_start[vhi])
        want = K12.residual_tables(torch.from_numpy(st.lanes[1, l0:l1]))
        tiles, order = seen[-1]
        assert torch.equal(tiles, want["tiles"])
        assert torch.equal(order, want["order"])
        assert tiles.dtype == order.dtype == torch.int32
    built = dict(st.tables)
    assert len(built) == len(bounds)
    for vlo, vhi in bounds:
        TS.decode_block(st, vlo, vhi)
    assert all(st.tables[k] is v for k, v in built.items())
