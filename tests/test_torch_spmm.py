"""The port's SpMM against the JAX package's: the plain version of kernel
K1 against the Pallas kernel (interpret mode) and the XLA ELL path, and
``spmm``'s forward and gradients against ``jax.grad`` of JAX ``spmm``.
Tolerances: float32 sums taken in another order, rtol = atol = 1e-5
(the row-rule emulation: rtol 1e-5, atol 1e-6)."""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.transforms import add_selfloop, gcn_edge_norms
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.ops.spmm import spmm as jax_spmm
from graphaibench_tpu.ops.spmm import spmm_ell as jax_spmm_ell
from graphaibench_tpu.ops.pallas_spmm import spmm_ell_pallas
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import ell_spmm as K1
from graphaibench_tpu_torch.ops import spmm as tspmm
from test_torch_device_graph import hubs_graph

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graphs():
    g = add_selfloop(rmat(10, 8, seed=0))
    return g, jdgm.to_device_graph(g, seg_ell=False), \
        tdgm.to_device_graph(g, device="cpu")


def _inputs(g, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(g.ne).astype(np.float32),
            rng.standard_normal((g.nv, f)).astype(np.float32),
            rng.standard_normal((g.nv, f)).astype(np.float32))


@pytest.mark.parametrize("f", [16, 128])
def test_ell_spmm_plain_matches_pallas_and_xla(graphs, f):
    g, jdg, tdg = graphs
    w, x, _ = _inputs(g, f)
    pallas = np.asarray(spmm_ell_pallas(jdg, jnp.asarray(w), jnp.asarray(x),
                                        interpret=True))
    xla = np.asarray(jax_spmm_ell(jdg, jnp.asarray(w), jnp.asarray(x)))
    wp = tdgm.pack_edge_values(tdg, torch.from_numpy(w))
    ours = K1.ell_spmm_plain(tdg, wp.fwd, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, xla, **TOL)
    # the transpose view is the adjoint: the same pass on w[trans_perm]
    ours_t = K1.ell_spmm_plain(tdg, wp.t, torch.from_numpy(x)).numpy()
    wt = jnp.asarray(w)[jdg.trans_perm]
    xla_t = np.asarray(jax_spmm_ell(jdg, wt, jnp.asarray(x)))
    np.testing.assert_allclose(ours_t, xla_t, **TOL)


@pytest.mark.parametrize("impl", ["ell", "coo", "dense", "packed"])
def test_spmm_forward_and_grads_match_jax(graphs, impl):
    g, jdg, tdg = graphs
    w, x, ct = _inputs(g, 16, seed=2)

    if impl == "packed":
        jw = jdgm.pack_edge_values(jdg, jnp.asarray(w))
        jimpl = "ell"
    else:
        jw, jimpl = jnp.asarray(w), impl

    def jloss(w_, x_):
        return jnp.sum(jax_spmm(jdg, w_, x_, jimpl) * jnp.asarray(ct))

    jout = np.asarray(jax_spmm(jdg, jw, jnp.asarray(x), jimpl))
    jdw, jdx = jax.grad(jloss, argnums=(0, 1))(jw, jnp.asarray(x))
    if impl == "packed":
        jdw = jdw.raw

    tw = torch.from_numpy(w).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    if impl == "packed":
        arg = dataclasses.replace(
            tdgm.pack_edge_values(tdg, torch.from_numpy(w)), raw=tw)
        timpl = "ell"
    else:
        arg, timpl = tw, impl
    out = tspmm.spmm(tdg, arg, tx, timpl)
    (out * torch.from_numpy(ct)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def test_adjoint_skipped_when_input_needs_no_grad(graphs, monkeypatch):
    """GCN's first layer aggregates the constant features: backward must
    not run the adjoint SpMM (nor the SDDMM for constant weights)."""
    g, _, tdg = graphs
    w, x, _ = _inputs(g, 8)
    wp = tdgm.pack_edge_values(tdg, torch.from_numpy(w))
    calls = []
    orig = tspmm.ell_spmm
    monkeypatch.setattr(tspmm, "ell_spmm",
                        lambda *a: calls.append(a[1]) or orig(*a))
    param = torch.ones(8, 8, requires_grad=True)
    h = tspmm.spmm(tdg, wp, torch.from_numpy(x), "ell")
    (h @ param).sum().backward()
    assert calls == [wp.fwd]
    assert param.grad is not None


def test_pick_impl_threshold(graphs):
    _, _, tdg = graphs
    assert tspmm._pick_impl(tdg, "auto") == "dense"   # nv = 1024 <= 4096
    assert tspmm._pick_impl(tdg, "coo") == "coo"
    big = dataclasses.replace(tdg, nv=4097)
    assert tspmm._pick_impl(big, "auto") == "ell"
    assert tspmm._pick_impl(dataclasses.replace(big, ell=()), "auto") == "coo"


def test_cpu_tensors_take_plain_version_without_launching(graphs):
    _, _, tdg = graphs
    wp = tdgm.pack_edge_values(tdg, torch.ones(tdg.ne))
    before = K1.LAUNCHES
    out = K1.ell_spmm(tdg, wp.fwd, torch.ones(tdg.nv, 4))
    assert K1.LAUNCHES == before
    np.testing.assert_allclose(
        out.numpy(), K1.ell_spmm_plain(tdg, wp.fwd, torch.ones(tdg.nv, 4)))


def test_ell_spmm_rejects_what_the_kernel_does_not_take(graphs):
    _, _, tdg = graphs
    wp = tdgm.pack_edge_values(tdg, torch.ones(tdg.ne))
    x = torch.ones(tdg.nv, 4)
    with pytest.raises(ValueError, match="float32"):
        K1.ell_spmm(tdg, wp.fwd, x.double())
    with pytest.raises(ValueError, match="rows"):
        K1.ell_spmm(tdg, wp.fwd, x[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        K1.ell_spmm(tdg, wp.fwd, torch.ones(4, tdg.nv).t())
    with pytest.raises(ValueError, match="buckets"):
        K1.ell_spmm(tdg, wp.fwd[:-1], x)


def test_sddmm_dot_guard_off_the_cpu(graphs):
    """Off the CPU ``sddmm_dot`` is still plain PyTorch on a graph without
    ELL buckets and on any device that is not CUDA (a meta tensor stands
    in for one); only a CUDA graph with buckets takes the kernel."""
    _, _, tdg = graphs
    a = torch.empty(tdg.nv, 4, device="meta")
    meta = dataclasses.replace(tdg, edge_src=tdg.edge_src.to("meta"),
                               col_idx=tdg.col_idx.to("meta"))
    out = tspmm.sddmm_dot(meta, a, a)
    assert out.device.type == "meta" and out.shape == (tdg.ne,)
    assert tspmm.sddmm_dot(meta, a, a, chunk_elems=4 * 1000).shape == (tdg.ne,)


def test_kernel_build_raises_without_cuda():
    """No fallback: on a host without a CUDA device or nvcc, the kernel
    library's entry raises instead of handing back something else."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the build guard cannot fire")
    for name in ("ell_spmm", "fused_gat", "ell_edge"):
        with pytest.raises(RuntimeError, match="CUDA|nvcc"):
            _build.load_library(name)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(graphs):
    """K1 against its plain version on the card (run by chip_smoke.py's
    kernel phase at full size; here at rmat10)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    g, _, _ = graphs
    dg = tdgm.to_device_graph(g, device="cuda")
    w, x, _ = _inputs(g, 128)
    wp = tdgm.pack_edge_values(dg, torch.from_numpy(w).cuda())
    xc = torch.from_numpy(x).cuda()
    before = K1.LAUNCHES
    out = K1.ell_spmm(dg, wp.fwd, xc)
    assert K1.LAUNCHES == before + 1          # one launch over all buckets
    # atomics add split rows' pieces in a run-dependent order
    torch.testing.assert_close(out, K1.ell_spmm_plain(dg, wp.fwd, xc),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2, 3, 7])
def test_narrow_kernel_matches_plain_on_cuda(graphs, f):
    """K1 below F = 4 (its narrow instantiation, a thread a virtual row)
    and at F = 7 (its scalar one) against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    g, _, _ = graphs
    dg = tdgm.to_device_graph(g, device="cuda")
    w, x, _ = _inputs(g, f)
    wp = tdgm.pack_edge_values(dg, torch.from_numpy(w).cuda())
    xc = torch.from_numpy(x).cuda()
    before = K1.LAUNCHES
    out = K1.ell_spmm(dg, wp.fwd, xc)
    assert K1.LAUNCHES == before + 1
    torch.testing.assert_close(out, K1.ell_spmm_plain(dg, wp.fwd, xc),
                               rtol=1e-4, atol=1e-4)


# ---- the kernel's design, as far as the CPU reaches it --------------------

ROW_RULE_GRAPHS = {
    "hubs": hubs_graph,    # degrees 64, 65, 199, 1 and 0
    "rmat10": lambda: rmat(10, 8, seed=0),               # degree-0 rows
    "rmat10_selfloops": lambda: add_selfloop(rmat(10, 8, seed=0)),
}


def _row_rule(dg, w_slots, x):
    """What the kernel does to its output, emulated on the CPU: ``out`` is
    uninitialised (NaN here) but for ``zero_rows``; a virtual row of an
    unsplit row is stored, a piece of a split row is added."""
    out = torch.full((dg.nv, x.shape[1]), float("nan"))
    out[dg.zero_rows] = 0.0
    for b, w in zip(dg.ell, w_slots):
        nbr = b.nbr.view(b.rows, b.width).long()
        contrib = (w.view(b.rows, b.width, 1) * x[nbr]).sum(1)
        split = dg.is_split[b.row_ids.long()] != 0
        out[b.row_ids[~split].long()] = contrib[~split]
        out.index_add_(0, b.row_ids[split], contrib[split])
    return out


@pytest.mark.parametrize("f", [128, 16, 7])
@pytest.mark.parametrize("name", sorted(ROW_RULE_GRAPHS))
def test_row_rule_matches_plain_and_jax(name, f):
    g = ROW_RULE_GRAPHS[name]()
    jdg = jdgm.to_device_graph(g, seg_ell=False)
    tdg = tdgm.to_device_graph(g, device="cpu")
    # the main path's weights (GCN norms): the sums are well conditioned,
    # so float32 reordering stays inside rtol 1e-5 / atol 1e-6
    w = gcn_edge_norms(g)
    _, x, _ = _inputs(g, f, seed=3)
    wp = tdgm.pack_edge_values(tdg, torch.from_numpy(w))
    tol = dict(rtol=1e-5, atol=1e-6)
    for view, jw in ((wp.fwd, jnp.asarray(w)),
                     (wp.t, jnp.asarray(w)[jdg.trans_perm])):
        ours = _row_rule(tdg, view, torch.from_numpy(x)).numpy()
        assert np.isfinite(ours).all(), "a row was neither stored nor zeroed"
        plain = K1.ell_spmm_plain(tdg, view, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(ours, plain, **tol)
        pallas = np.asarray(spmm_ell_pallas(jdg, jw, jnp.asarray(x),
                                            interpret=True))
        xla = np.asarray(jax_spmm_ell(jdg, jw, jnp.asarray(x)))
        np.testing.assert_allclose(ours, pallas, **tol)
        np.testing.assert_allclose(ours, xla, **tol)


def test_launch_table_is_built_once_per_weight_view(graphs, monkeypatch):
    """A ``SlotWeights`` view is validated, and its table built, at its
    first SpMM; a plain tuple gets a table per call."""
    _, _, tdg = graphs
    wp = tdgm.pack_edge_values(tdg, torch.ones(tdg.ne))
    built = []
    orig = K1._LaunchTable.__init__
    monkeypatch.setattr(K1._LaunchTable, "__init__",
                        lambda self, g, w: built.append(w) or orig(self, g, w))
    x = torch.ones(tdg.nv, 4)
    for _ in range(3):
        K1.ell_spmm(tdg, wp.fwd, x)
        K1.ell_spmm(tdg, wp.t, x)
    assert built == [wp.fwd, wp.t]
    assert wp.fwd.launch_table.graph is tdg
    plain_tuple = tuple(wp.fwd)
    K1.ell_spmm(tdg, plain_tuple, x)
    K1.ell_spmm(tdg, plain_tuple, x)
    assert len(built) == 4
    # the same weights on another graph object are checked again
    other = dataclasses.replace(tdg)
    K1.ell_spmm(other, wp.fwd, x)
    assert len(built) == 5 and wp.fwd.launch_table.graph is other


def test_weights_and_graph_die_with_their_last_reference(graphs):
    """A weight view's launch table holds no reference back to the view, so
    a model's packed weights and its graph are freed when the last
    reference goes, with the garbage collector off: no cycle holds device
    memory until a collection."""
    g = tdgm.to_device_graph(graphs[0], device="cpu")
    wp = tdgm.pack_edge_values(g, torch.ones(g.ne))
    K1.ell_spmm(g, wp.fwd, torch.ones(g.nv, 4))
    assert wp.fwd.launch_table.graph is g
    slot, ids = weakref.ref(wp.fwd[0]), weakref.ref(g.ell[0].nbr)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del wp, g
        assert slot() is None and ids() is None
    finally:
        if enabled:
            gc.enable()


def test_launch_table_lists_the_widest_bucket_first(graphs):
    _, _, tdg = graphs
    wp = tdgm.pack_edge_values(tdg, torch.ones(tdg.ne))
    table = K1._LaunchTable(tdg, wp.fwd)
    widths = [b.width for b in tdg.ell]
    assert list(table.widths) == sorted(widths, reverse=True)
    by_width = {b.width: (b, w) for b, w in zip(tdg.ell, wp.fwd)}
    for i, width in enumerate(table.widths):
        b, w = by_width[width]
        assert table.rows[i] == b.rows
        assert table.row_ids[i] == b.row_ids.data_ptr()
        assert table.nbr[i] == b.nbr.data_ptr()
        assert table.w[i] == w.data_ptr()
    assert table.n == len(tdg.ell) <= K1.MAX_BUCKETS
    assert table.vec_ok


def test_launch_table_sends_odd_widths_to_the_scalar_instantiation():
    g = add_selfloop(rmat(8, 8, seed=0))
    tdg = tdgm.to_device_graph(g, device="cpu")
    ell = tuple(tdgm.build_ell_buckets(g, device="cpu", split=5))
    assert [b.width for b in ell] == [4, 5]
    odd = dataclasses.replace(tdg, ell=ell)
    table = K1._LaunchTable(odd, tuple(torch.ones(b.nbr.shape) for b in ell))
    assert not table.vec_ok
    assert list(table.widths) == [5, 4]


def test_launch_table_refuses_more_buckets_than_the_kernel_holds(graphs):
    _, _, tdg = graphs
    many = dataclasses.replace(tdg, ell=tdg.ell * 3)
    assert len(many.ell) > K1.MAX_BUCKETS
    with pytest.raises(ValueError, match="table"):
        K1.ell_spmm(many, tuple(torch.ones(b.nbr.shape) for b in many.ell),
                    torch.ones(tdg.nv, 4))


@pytest.mark.parametrize("nv,f,tile", [
    (1 << 17, 128, 32),    # x of 64 MB: the 16 MB slice
    (1 << 17, 16, 16),     # 8 MB: no tiling
    (1 << 15, 128, 128),   # 16 MB: no tiling
    (1 << 16, 128, 64),
    (1 << 22, 128, 32),    # never below one 128-byte line
    (1 << 17, 100, 32),
    (1 << 10, 8, 8),
    (1 << 10, 256, 128),   # a lane holds one float4: 128 floats at most
])
def test_tile_rule(nv, f, tile):
    assert K1._tile_floats(nv, f) == tile
    assert tile % 4 == 0 and tile // 4 <= 32


# ---- rectangular tables (the sharded trainer's) ----------------------------

# name -> (output rows, gathered rows, edges, hub rows of degree 150 and 65)
RECT = {
    "wide": (40, 90, 400, False),
    "tall": (90, 40, 400, False),
    "hubs": (40, 90, 300, True),
}


def _rect(name, seed=0, device="cpu"):
    """A random rectangular table and its transpose (``local_table``),
    per-slot weights, and the dense matrix they stand for (float64)."""
    n_rows, n_cols, ne, hub = RECT[name]
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, ne)
    if hub:
        rows = np.concatenate([rows, np.full(150, 3), np.full(65, n_rows - 1)])
    cols = rng.integers(0, n_cols, len(rows))
    eids = rng.permutation(len(rows))
    w = rng.random(len(rows)).astype(np.float32)
    kw = dict(sentinel=len(rows), device=device)
    fwd = tdgm.local_table(rows, cols, eids, n_rows=n_rows, n_cols=n_cols, **kw)
    trans = tdgm.local_table(cols, rows, eids, n_rows=n_cols, n_cols=n_rows,
                             **kw)
    a = np.zeros((n_rows, n_cols))
    np.add.at(a, (rows, cols), w[eids])
    return fwd, trans, torch.from_numpy(w).to(device), a


@pytest.mark.parametrize("f", [16, 7])
@pytest.mark.parametrize("name", sorted(RECT))
def test_rectangular_tables_match_dense(name, f):
    """K1's plain version and the kernel's row rule on a table of nv rows
    over n_cols gathered rows, and on its transpose (the adjoint): A x
    and A^T ct."""
    fwd, trans, w, a = _rect(name)
    if name == "hubs":
        assert int(fwd.is_split.sum()) == 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((fwd.n_cols, f)).astype(np.float32)
    ct = rng.standard_normal((fwd.nv, f)).astype(np.float32)
    for table, inp, want in ((fwd, x, a @ x), (trans, ct, a.T @ ct)):
        view = tdgm.pack_slot_values(table, w)
        got = K1.ell_spmm(table, view, torch.from_numpy(inp))
        assert got.shape == (table.nv, f)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        rule = _row_rule(table, view, torch.from_numpy(inp))
        assert not torch.isnan(rule).any()
        torch.testing.assert_close(rule, got, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="gathers from"):
        K1.ell_spmm(fwd, tdgm.pack_slot_values(fwd, w),
                    torch.zeros(fwd.nv, f))


@pytest.mark.parametrize("make", [lambda: add_selfloop(rmat(10, 8, seed=0)),
                                  hubs_graph], ids=["rmat10", "hubs"])
def test_square_graph_takes_the_tables_it_took_before(make):
    """A square graph gathers from its own rows (n_cols = nv, kept by a
    copy), and the rectangular table built from its COO list is its ELL
    layout bucket for bucket, with the same results."""
    g = make()
    dg = tdgm.to_device_graph(g, device="cpu")
    assert dg.n_cols == dg.nv == g.nv
    assert dataclasses.replace(dg).n_cols == g.nv
    src, dst = g.coo()
    t = tdgm.local_table(src, dst, np.arange(g.ne), n_rows=g.nv, n_cols=g.nv,
                         sentinel=g.ne, device="cpu")
    assert len(t.ell) == len(dg.ell)
    for a, b in zip(t.ell, dg.ell):
        assert a.width == b.width
        for k in ("row_ids", "nbr", "edge_id", "valid"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(t.is_split, dg.is_split)
    assert torch.equal(t.zero_rows, dg.zero_rows)
    w = torch.from_numpy(np.random.default_rng(2).random(g.ne).astype(
        np.float32))
    x = torch.randn(g.nv, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(K1.ell_spmm(t, tdgm.pack_slot_values(t, w), x),
                       K1.ell_spmm(dg, tdgm.pack_edge_values(dg, w).fwd, x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RECT))
def test_rectangular_kernel_matches_plain_on_cuda(name):
    """K1 on a rectangular table and its transpose, on the card (run by
    chip_smoke.py's sharded phase on a rank's tables at rmat13)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    fwd, trans, w, _ = _rect(name, device="cuda")
    for table in (fwd, trans):
        view = tdgm.pack_slot_values(table, w)
        x = torch.randn(table.n_cols, 128, device="cuda")
        torch.testing.assert_close(K1.ell_spmm(table, view, x),
                                   K1.ell_spmm_plain(table, view, x),
                                   rtol=1e-4, atol=1e-4)
