"""The port's fused GAT attention against the JAX package's. v2: the
plain PyTorch version of each of the bucket passes (the backward as two
passes and as one), the whole forward and the three gradients, against
``gat_attention_spmm_v2`` and ``jax.grad`` of it, against the port's own
unfused path, on edgeless rows, and a CPU emulation of the kernels'
store-or-combine rule. v1
(per-edge logits and weights or masks, at the end of the file): the same
against ``gat_attention_spmm``, and ``apply_model`` with its default
``trivial_w``.

Tolerances: both sides are float32 with sums taken in another order;
values rtol = atol = 2e-5, gradients 1e-4, as the JAX package's own test
of v2 against v1 (tests/test_ops.py::test_gat_v2_matches_v1_with_grads).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.transforms import add_selfloop
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.ops import fused_gat as jfg
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import ell_edge as tee
from graphaibench_tpu_torch.ops import fused_gat as tfg
from graphaibench_tpu_torch.ops import math as tmath
from graphaibench_tpu_torch.ops.segment import segment_softmax
from graphaibench_tpu_torch.ops.spmm import sddmm_add, spmm
from test_torch_device_graph import hubs_graph

torch.set_num_threads(2)

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)

GRAPHS = {
    "hubs": (hubs_graph, 16),          # degrees 64, 65, 199, 1 and 0
    "hubs_f7": (hubs_graph, 7),
    "rmat8": (lambda: rmat(8, 8, seed=3), 16),   # tests/test_ops.py:342
    "rmat8_selfloops": (lambda: add_selfloop(rmat(8, 8, seed=3)), 16),
}
# the backward's cases: split rows (degree > 64) and an edgeless row in
# each, at the main path's two widths and with float columns
BWD_GRAPHS = {
    **{k: GRAPHS[k] for k in ("hubs", "hubs_f7", "rmat8")},
    "hubs_f128": (hubs_graph, 128),
    "rmat8_f128": (lambda: rmat(8, 8, seed=3), 128),
}


def _case(name):
    make, f = {**GRAPHS, **BWD_GRAPHS}[name]
    g = make()
    rng = np.random.default_rng(0)
    arrs = dict(h=rng.standard_normal((g.nv, f)).astype(np.float32),
                sl=rng.standard_normal(g.nv).astype(np.float32),
                sr=rng.standard_normal(g.nv).astype(np.float32),
                ct=rng.standard_normal((g.nv, f)).astype(np.float32))
    return (g, jdgm.to_device_graph(g, seg_ell=False),
            tdgm.to_device_graph(g, device="cpu"), arrs)


def _t(arrs, *names):
    return [torch.from_numpy(arrs[n]) for n in names]


def _j(arrs, *names):
    return [jnp.asarray(arrs[n]) for n in names]


def _jax_row_max(jdg, jsl, jsr):
    m0 = jfg._sr_rowmax(jdg, jsr)
    raw = jsl + jnp.where(jnp.isfinite(m0), m0, 0.0)
    return m0, jnp.where(raw > 0, raw, 0.2 * raw)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_passes_match_jax(name):
    """gat_rowmax and gat_v2_fwd against ``_sr_rowmax`` and
    ``_v2_fwd_pass``; the two backward passes against the cotangents of
    ``_v2_bwd`` on the same residuals."""
    g, jdg, tdg, arrs = _case(name)
    sl, sr, h, ct = _t(arrs, "sl", "sr", "h", "ct")
    jsl, jsr, jh, jct = _j(arrs, "sl", "sr", "h", "ct")

    jm0, jm = jax.jit(lambda a, b: _jax_row_max(jdg, a, b))(jsl, jsr)
    m0 = tfg.gat_rowmax_plain(tdg, sr)
    np.testing.assert_array_equal(m0.numpy(), np.asarray(jm0))
    assert np.isneginf(m0.numpy()[g.degrees() == 0]).all()

    jout, jzinv = jax.jit(
        lambda a, b, x, m_: jfg._v2_fwd_pass(jdg, a, b, x, m_))(jsl, jsr, jh, jm)
    m = torch.from_numpy(np.asarray(jm))
    acc, z = tfg.gat_v2_fwd_plain(tdg, sl, sr, m, h)
    zinv = 1.0 / torch.clamp(z, min=tfg.Z_FLOOR)
    np.testing.assert_allclose(zinv.numpy(), np.asarray(jzinv), **VAL)
    np.testing.assert_allclose((acc * zinv[:, None]).numpy(),
                               np.asarray(jout), **VAL)

    jdsl, jdsr, jdh = jax.jit(
        lambda *res: jfg._v2_bwd((jdg, *res[:-1]), res[-1])[1:])(
            jsl, jsr, jh, jm, jzinv, jout, jct)
    out = torch.from_numpy(np.asarray(jout))
    zinv = torch.from_numpy(np.asarray(jzinv))
    inner = (ct * out).sum(1)
    d_sl = tfg.gat_v2_bwd_sl_plain(tdg, sl, sr, m, zinv, inner, h, ct)
    d_h, d_sr = tfg.gat_v2_bwd_h_plain(tdg, sl, sr, m, zinv, inner, h, ct)
    np.testing.assert_allclose(d_sl.numpy(), np.asarray(jdsl), **GRAD)
    np.testing.assert_allclose(d_sr.numpy(), np.asarray(jdsr), **GRAD)
    np.testing.assert_allclose(d_h.numpy(), np.asarray(jdh), **GRAD)


def _torch_value_and_grads(fn, arrs, needs=("sl", "sr", "h")):
    """[out, d_sl, d_sr, d_h]; None for an input not in ``needs``."""
    sl, sr, h = (t.requires_grad_(n in needs)
                 for t, n in zip(_t(arrs, "sl", "sr", "h"), ("sl", "sr", "h")))
    out = fn(sl, sr, h)
    (out * torch.from_numpy(arrs["ct"])).sum().backward()
    return [out.detach().numpy(),
            *(None if t.grad is None else t.grad.numpy() for t in (sl, sr, h))]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fused_op_and_grads_match_jax(name):
    _, jdg, tdg, arrs = _case(name)
    jsl, jsr, jh, jct = _j(arrs, "sl", "sr", "h", "ct")
    # jitted: one compile instead of one per eager op and shape
    jout = jax.jit(lambda a, b, x: jfg.gat_attention_spmm_v2(jdg, a, b, x))(
        jsl, jsr, jh)
    jgrads = jax.jit(jax.grad(
        lambda a, b, x: (jfg.gat_attention_spmm_v2(jdg, a, b, x) * jct).sum(),
        argnums=(0, 1, 2)))(jsl, jsr, jh)
    before = dict(tfg.LAUNCHES)
    ours = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(tdg, a, b, x), arrs)
    assert tfg.LAUNCHES == before      # CPU tensors launch nothing
    np.testing.assert_allclose(ours[0], np.asarray(jout), **VAL)
    for mine, theirs, what in zip(ours[1:], jgrads, ("d_sl", "d_sr", "d_h")):
        np.testing.assert_allclose(mine, np.asarray(theirs), err_msg=what,
                                   **GRAD)


@pytest.mark.parametrize("name", sorted(BWD_GRAPHS))
def test_single_pass_plain_matches_the_two_passes(name):
    """``gat_v2_bwd_plain`` sums the per-slot terms by row for d_sr and by
    neighbour for d_sl, from the transpose role alone; the two passes'
    plain versions sum d_sl in the forward role."""
    g, _, tdg, arrs = _case(name)
    assert int(tdg.is_split.sum()) > 0 and (g.degrees() == 0).any()
    sl, sr, h, ct = _t(arrs, "sl", "sr", "h", "ct")
    m0 = tfg.gat_rowmax_plain(tdg, sr)
    m = tfg._leaky(sl + torch.where(torch.isfinite(m0), m0,
                                    torch.zeros_like(m0)))
    acc, z = tfg.gat_v2_fwd_plain(tdg, sl, sr, m, h)
    zinv = 1.0 / torch.clamp(z, min=tfg.Z_FLOOR)
    bwd = (sl, sr, m, zinv, (ct * acc * zinv[:, None]).sum(1), h, ct)
    before = dict(tfg.LAUNCHES)
    d_sl, d_sr, d_h = tfg.gat_v2_bwd(tdg, *bwd)     # a CPU tensor: plain
    assert tfg.LAUNCHES == before
    d_h_p, d_sr_p = tfg.gat_v2_bwd_h_plain(tdg, *bwd)
    torch.testing.assert_close(d_h, d_h_p, rtol=0, atol=0)
    torch.testing.assert_close(d_sr, d_sr_p, rtol=0, atol=0)
    # hub rows sum hundreds of terms of the size of the largest outputs
    np.testing.assert_allclose(
        d_sl.numpy(), tfg.gat_v2_bwd_sl_plain(tdg, *bwd).numpy(), rtol=1e-4,
        atol=1e-4 * max(1.0, float(d_sl.abs().max())))
    assert (d_sl[torch.from_numpy(g.degrees() == 0)] == 0).all()


@pytest.mark.parametrize("needs", ["sl", "h", "all"])
@pytest.mark.parametrize("name", sorted(BWD_GRAPHS))
def test_backward_routes_match_jax(name, needs, monkeypatch):
    """The three routes of ``_GatV2.backward`` against ``jax.grad``: ``sl``
    alone (gat_v2_bwd_sl), ``h`` alone (gat_v2_bwd_h), and all three with
    the single pass (gat_v2_bwd), which the size rule keeps for large
    matrices and the test forces here."""
    _, jdg, tdg, arrs = _case(name)
    jsl, jsr, jh, jct = _j(arrs, "sl", "sr", "h", "ct")
    jgrads = jax.jit(jax.grad(
        lambda a, b, x: (jfg.gat_attention_spmm_v2(jdg, a, b, x) * jct).sum(),
        argnums=(0, 1, 2)))(jsl, jsr, jh)
    calls = []
    for fn in ("gat_v2_bwd_sl", "gat_v2_bwd_h", "gat_v2_bwd"):
        monkeypatch.setattr(tfg, fn, lambda *a, fn=fn, real=getattr(tfg, fn):
                            (calls.append(fn), real(*a))[1])
    monkeypatch.setattr(tfg, "_single_pass", lambda nv, f: True)
    ours = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(tdg, a, b, x), arrs,
        needs=("sl", "sr", "h") if needs == "all" else (needs,))
    assert calls == [{"sl": "gat_v2_bwd_sl", "h": "gat_v2_bwd_h",
                      "all": "gat_v2_bwd"}[needs]]
    for mine, theirs, what in zip(ours[1:], jgrads, ("sl", "sr", "h")):
        if needs != "all" and what != needs:
            assert mine is None
        else:
            np.testing.assert_allclose(mine, np.asarray(theirs),
                                       err_msg=f"d_{what}", **GRAD)


def _unfused(tdg, sl, sr, h):
    logits = tmath.leaky_relu(sddmm_add(tdg, sl, sr), 0.2)
    return spmm(tdg, segment_softmax(tdg, logits), h, "ell")


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fused_op_matches_the_ports_unfused_path(name):
    _, _, tdg, arrs = _case(name)
    fused = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(tdg, a, b, x), arrs)
    plain = _torch_value_and_grads(lambda a, b, x: _unfused(tdg, a, b, x),
                                   arrs)
    np.testing.assert_allclose(fused[0], plain[0], **VAL)
    for a, b, what in zip(fused[1:], plain[1:], ("d_sl", "d_sr", "d_h")):
        np.testing.assert_allclose(a, b, err_msg=what, **GRAD)


def test_edgeless_rows_give_finite_zeros():
    """An edgeless row has z = 0: the 1e-30 floor keeps 1/z finite, so the
    row's output and its gradients are 0, not NaN — on the JAX side too
    (tests/test_ops.py holds v1 to the same rule)."""
    rp = np.array([0, 2, 4, 6, 6], np.int64)       # vertex 3: no edges
    ci = np.array([1, 2, 0, 2, 0, 1], np.int32)
    g = CSRGraph(row_ptr=rp, col_idx=ci)
    tdg = tdgm.to_device_graph(g, device="cpu")
    jdg = jdgm.to_device_graph(g, seg_ell=False)
    rng = np.random.default_rng(0)
    arrs = dict(h=rng.standard_normal((4, 8)).astype(np.float32),
                sl=rng.standard_normal(4).astype(np.float32),
                sr=rng.standard_normal(4).astype(np.float32),
                ct=np.ones((4, 8), np.float32))
    ours = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(tdg, a, b, x), arrs)
    for a in ours:
        assert np.isfinite(a).all()
    assert (ours[0][3] == 0).all() and ours[1][3] == 0
    jout = jfg.gat_attention_spmm_v2(jdg, *_j(arrs, "sl", "sr", "h"))
    np.testing.assert_allclose(ours[0], np.asarray(jout), **VAL)
    assert np.finfo(np.float32).tiny <= np.float32(tfg.Z_FLOOR)


# ---- the kernels' design, as far as the CPU reaches it --------------------

def _combine_rule(dg, shape, init, pieces, combine):
    """What a kernel does to one output, emulated on the CPU: ``out`` is
    uninitialised (NaN here) but for ``zero_rows``, which hold ``init``;
    the piece of an unsplit row is stored, the pieces of a split row are
    combined into what is there."""
    out = torch.full(shape, float("nan"))
    out[dg.zero_rows] = init
    for b, piece in zip(dg.ell, pieces):
        rows = b.row_ids.long()
        split = dg.is_split[rows] != 0
        out[rows[~split]] = piece[~split]
        combine(out, rows[split], piece[split])
    return out


def _add(out, rows, piece):
    out.index_add_(0, rows, piece)


def _amax(out, rows, piece):
    out.scatter_reduce_(0, rows, piece, "amax")


def _per_bucket(dg, fn):
    """``fn`` of each bucket taken alone: the pieces a kernel computes
    per virtual row, over the first ``valid`` slots only."""
    out = []
    for b in dg.ell:
        nbr = b.nbr.view(b.rows, b.width).long()
        live = torch.arange(b.width)[None, :] < b.valid[:, None]
        out.append(fn(b.row_ids.long(), nbr, live))
    return out


@pytest.mark.parametrize("name", ["hubs", "hubs_f7", "rmat8"])
def test_store_or_combine_rule_matches_plain(name):
    """Every row is stored once or initialised and combined, never left
    unwritten, and looping over the first ``valid`` slots equals masking
    by the pad sentinel."""
    g, _, dg, arrs = _case(name)
    sl, sr, h, ct = _t(arrs, "sl", "sr", "h", "ct")
    f = h.shape[1]
    for b in dg.ell:      # the pads sit at the tail: valid counts them out
        real = b.edge_id.view(b.rows, b.width) != dg.ne
        assert torch.equal(real, torch.arange(b.width)[None, :]
                           < b.valid[:, None])
        assert int(b.valid.min()) >= 1

    m0 = _combine_rule(dg, (g.nv,), float("-inf"), _per_bucket(
        dg, lambda rows, nbr, live: sr[nbr].masked_fill(~live, float("-inf"))
        .amax(1)), _amax)
    assert not torch.isnan(m0).any()
    assert torch.equal(m0, tfg.gat_rowmax_plain(dg, sr))

    m = tfg._leaky(sl + torch.where(torch.isfinite(m0), m0,
                                    torch.zeros_like(m0)))

    def e_of(rows, nbr, live):
        raw = sl[rows][:, None] + sr[nbr]
        return torch.exp(tfg._leaky(raw) - m[rows][:, None]) * live

    acc = _combine_rule(dg, (g.nv, f), 0.0, _per_bucket(
        dg, lambda rows, nbr, live: (e_of(rows, nbr, live)[:, :, None]
                                     * h[nbr]).sum(1)), _add)
    z = _combine_rule(dg, (g.nv,), 0.0, _per_bucket(
        dg, lambda rows, nbr, live: e_of(rows, nbr, live).sum(1)), _add)
    acc_p, z_p = tfg.gat_v2_fwd_plain(dg, sl, sr, m, h)
    assert not torch.isnan(acc).any() and not torch.isnan(z).any()
    torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-6)

    # the backward kernels' arithmetic: the dot products are summed per
    # lane over the slots and the term with inner is subtracted once
    zinv = 1.0 / torch.clamp(z_p, min=tfg.Z_FLOOR)
    inner = (ct * acc_p * zinv[:, None]).sum(1)

    def d_sl_piece(rows, nbr, live):
        raw = sl[rows][:, None] + sr[nbr]
        pl = e_of(rows, nbr, live) * zinv[rows][:, None] * tfg._leaky_grad(raw)
        a = (pl[:, :, None] * ct[rows][:, None, :] * h[nbr]).sum((1, 2))
        return a - inner[rows] * pl.sum(1)

    d_sl = _combine_rule(dg, (g.nv,), 0.0, _per_bucket(dg, d_sl_piece), _add)
    assert not torch.isnan(d_sl).any()
    torch.testing.assert_close(
        d_sl, tfg.gat_v2_bwd_sl_plain(dg, sl, sr, m, zinv, inner, h, ct),
        rtol=1e-4, atol=1e-5)

    def p_t(rows, nbr, live):
        raw = sl[nbr] + sr[rows][:, None]
        p = torch.exp(tfg._leaky(raw) - m[nbr]) * zinv[nbr] * live
        return p, p * tfg._leaky_grad(raw)

    d_h = _combine_rule(dg, (g.nv, f), 0.0, _per_bucket(
        dg, lambda rows, nbr, live: (p_t(rows, nbr, live)[0][:, :, None]
                                     * ct[nbr]).sum(1)), _add)

    def d_sr_piece(rows, nbr, live):
        pl = p_t(rows, nbr, live)[1]
        a = (pl[:, :, None] * h[rows][:, None, :] * ct[nbr]).sum((1, 2))
        return a - (pl * inner[nbr]).sum(1)

    d_sr = _combine_rule(dg, (g.nv,), 0.0, _per_bucket(dg, d_sr_piece), _add)
    d_h_p, d_sr_p = tfg.gat_v2_bwd_h_plain(dg, sl, sr, m, zinv, inner, h, ct)
    assert not torch.isnan(d_h).any() and not torch.isnan(d_sr).any()
    torch.testing.assert_close(d_h, d_h_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d_sr, d_sr_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nv,f,aligned,want", [
    (1 << 17, 128, True, (16, 1, 2)),   # 64 floats a tile at every size
    (1 << 15, 128, True, (16, 1, 2)),
    (1 << 17, 16, True, (4, 1, 1)),
    (1 << 13, 64, True, (16, 1, 1)),
    (1 << 10, 256, True, (16, 1, 4)),
    (1 << 10, 7, True, (7, 0, 1)),      # F % 4 != 0: float columns
    (1 << 10, 50, True, (32, 0, 2)),    # a group is at most one warp
    (1 << 10, 16, False, (16, 0, 1)),   # unaligned: float columns
])
def test_wide_pass_shape_rule(nv, f, aligned, want):
    class _T:
        def data_ptr(self):
            return 256 if aligned else 260

    assert tfg._wide_shape(nv, f, _T(), _T(),
                           tile_floats=tfg._fwd_tile_floats) == want
    tile_v, vec, tiles = want
    assert 1 <= tile_v <= 32 and tiles * tile_v >= (f // 4 if vec else f)


@pytest.mark.parametrize("nv", [1 << 13, 1 << 17, 1 << 19, 1 << 21])
@pytest.mark.parametrize("f", [4, 16, 64, 128, 256])
def test_forward_tile_rule(nv, f):
    """gat_v2_fwd takes tiles of up to 64 floats whatever the graph's
    size (the rule before it took 128 while the slice fit 24 MiB), and
    the backward one tile of up to 128: each pass has its own rule."""
    class _T:
        def data_ptr(self):
            return 256

    assert tfg._fwd_tile_floats(nv, f) == min(f, 64)
    tile_v, vec, tiles = tfg._wide_shape(nv, f, _T(), _T(),
                                         tile_floats=tfg._fwd_tile_floats)
    assert (tile_v, vec, tiles) == (min(f, 64) // 4, 1, -(-f // 64))
    assert tfg._bwd_tile_floats(nv, f) == min(f, 128)


@pytest.mark.parametrize("nv", [1 << 17, 1 << 19])
@pytest.mark.parametrize("f,aligned,want", [
    (128, True, (32, 1, 1)),    # one tile at every size
    (16, True, (4, 1, 1)),
    (256, True, (32, 1, 2)),    # a tile is at most 32 columns of V
    (33, True, (32, 0, 2)),
    (128, False, (32, 0, 4)),   # unaligned: float columns
])
def test_backward_tile_rule(nv, f, aligned, want):
    class _T:
        def data_ptr(self):
            return 256 if aligned else 260

    assert tfg._bwd_tile_floats(nv, f) == min(f, 128)
    assert tfg._wide_shape(nv, f, _T(), _T(),
                           tile_floats=tfg._bwd_tile_floats) == want


@pytest.mark.parametrize("nv,f,want", [
    (1 << 17, 128, True), (1 << 17, 64, True), (1 << 17, 32, True),
    (1 << 17, 16, False), (1 << 17, 8, False),
    (1 << 19, 128, True), (1 << 19, 16, True), (1 << 19, 8, True),
    (1 << 19, 4, False), (1 << 13, 128, False),
])
def test_single_pass_rule(nv, f, want):
    """One backward pass from a 16 MiB matrix on: the cells it was
    measured at, and the small graphs of the tests, which take two."""
    assert tfg._single_pass(nv, f) is want


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, _, dg, arrs = _case("rmat8")
    sl, sr, h = _t(arrs, "sl", "sr", "h")
    with pytest.raises(ValueError, match="float32"):
        tfg.gat_rowmax(dg, sr.double())
    with pytest.raises(ValueError, match="shape"):
        tfg.gat_v2_fwd(dg, sl, sr[:-1], sl, h)
    with pytest.raises(ValueError, match="contiguous"):
        tfg.gat_v2_fwd(dg, sl, sr, sl, h.t().contiguous().t())


def test_rowmax_needs_int4_ids():
    """gat_rowmax's kernel reads a row's neighbour ids four at a time:
    every graph ``to_device_graph`` builds qualifies, and a bucket of
    another width or with ids that do not start on 16 bytes is refused
    before a launch."""
    g, _, dg, _ = _case("hubs")
    tfg._check_int4_ids(dg)
    odd = tdgm.build_ell_buckets(g, device="cpu", split=5)
    assert {b.width for b in odd} == {4, 5}
    with pytest.raises(ValueError, match="four at a time"):
        tfg._check_int4_ids(types.SimpleNamespace(ell=odd))
    b = dg.ell[0]
    shifted = torch.cat([b.nbr.new_zeros(1), b.nbr])[1:]
    assert shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="four at a time"):
        tfg._check_int4_ids(types.SimpleNamespace(
            ell=[dataclasses.replace(b, nbr=shifted)]))


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernels_match_plain_on_cuda(name, single, monkeypatch):
    """The kernels against their plain versions on the card, the backward
    in two passes and in one (run at full size by chip_smoke.py's kernel
    phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GAT kernels have no CPU mode")
    if single:
        monkeypatch.setattr(tfg, "_single_pass", lambda nv, f: True)
    g, _, _, arrs = _case(name)
    dg = tdgm.to_device_graph(g, device="cuda")
    fused = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(dg, a.cuda(), b.cuda(),
                                                  x.cuda()).cpu(), arrs)
    cpu = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(
            tdgm.to_device_graph(g, device="cpu"), a, b, x), arrs)
    for a, b in zip(fused, cpu):
        np.testing.assert_allclose(a, b, **GRAD)


# ---- rectangular tables (the sharded trainer's) ----------------------------

# name -> (output rows, gathered rows, edges, hub rows of degree 150 and 65, F)
RECT = {
    "wide": (40, 90, 400, False, 16),
    "tall_f7": (90, 40, 150, False, 7),      # rows without edges
    "hubs": (40, 90, 300, True, 16),
    "hubs_f128": (40, 90, 300, True, 128),
}


def _rect(name, device="cpu"):
    """A random rectangular table (``local_table``) and its transpose, the
    edges' multiplicities as a dense (rows, cols) matrix, and inputs:
    sl and ct over the output rows, sr and h over the gathered rows."""
    n_rows, n_cols, ne, hub, f = RECT[name]
    rng = np.random.default_rng(4)
    rows = rng.integers(0, n_rows, ne)
    if hub:
        rows = np.concatenate([rows, np.full(150, 3), np.full(65, n_rows - 1)])
    cols = rng.integers(0, n_cols, len(rows))
    eids = np.arange(len(rows))
    kw = dict(sentinel=len(rows), device=device)
    fwd = tdgm.local_table(rows, cols, eids, n_rows=n_rows, n_cols=n_cols, **kw)
    trans = tdgm.local_table(cols, rows, eids, n_rows=n_cols, n_cols=n_rows,
                             **kw)
    count = np.zeros((n_rows, n_cols))
    np.add.at(count, (rows, cols), 1.0)
    arrs = dict(sl=rng.standard_normal(n_rows).astype(np.float32),
                sr=rng.standard_normal(n_cols).astype(np.float32),
                h=rng.standard_normal((n_cols, f)).astype(np.float32),
                ct=rng.standard_normal((n_rows, f)).astype(np.float32))
    return fwd, trans, count, arrs


def _dense_gat(count, sl, sr, h):
    """The attention of a dense multiplicity matrix, in float64: each edge
    (i, j) weighs exp(leaky(sl_i + sr_j) - m_i) over its row's sum."""
    lg = tmath.leaky_relu(sl[:, None] + sr[None, :], 0.2)
    lg = torch.where(count > 0, lg, torch.full_like(lg, float("-inf")))
    m = lg.amax(1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = count * torch.exp(lg - m)
    return (e / e.sum(1, keepdim=True).clamp(min=tfg.Z_FLOOR)) @ h


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("name", sorted(RECT))
def test_rectangular_op_and_grads_match_dense(name, single, monkeypatch):
    """The fused op on a rectangular table with its transpose table in the
    backward's transpose role (single: the one pass, which adds d_sl by
    neighbour; else gat_v2_bwd_sl on the forward table)."""
    fwd, trans, count, arrs = _rect(name)
    monkeypatch.setattr(tfg, "_single_pass", lambda nv, f: single)
    ours = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(fwd, a, b, x, trans=trans),
        arrs)
    ins = [torch.tensor(arrs[k], dtype=torch.float64, requires_grad=True)
           for k in ("sl", "sr", "h")]
    want = _dense_gat(torch.from_numpy(count), *ins)
    (want * torch.from_numpy(arrs["ct"]).double()).sum().backward()
    np.testing.assert_allclose(ours[0], want.detach().numpy(), **VAL)
    for mine, t, what in zip(ours[1:], ins, ("d_sl", "d_sr", "d_h")):
        np.testing.assert_allclose(mine, t.grad.numpy(), err_msg=what, **GRAD)
    if name.startswith("tall"):
        assert (count.sum(1) == 0).any()     # edgeless rows: zeros, finite


def test_table_without_edges_gives_zeros():
    """A rank whose shard has no edge (tests/test_torch_partition.py's
    empty shard): the op's output and gradients are zeros and nothing is
    launched."""
    none = np.zeros(0, np.int64)
    fwd = tdgm.local_table(none, none, none, n_rows=8, n_cols=16, sentinel=8,
                           device="cpu")
    trans = tdgm.local_table(none, none, none, n_rows=16, n_cols=8,
                             sentinel=8, device="cpu")
    assert not fwd.has_ell_layout and fwd.zero_rows.numel() == 8
    rng = np.random.default_rng(0)
    arrs = dict(sl=rng.standard_normal(8).astype(np.float32),
                sr=rng.standard_normal(16).astype(np.float32),
                h=rng.standard_normal((16, 4)).astype(np.float32),
                ct=rng.standard_normal((8, 4)).astype(np.float32))
    for out in _torch_value_and_grads(
            lambda a, b, x: tfg.gat_attention_spmm_v2(fwd, a, b, x,
                                                      trans=trans), arrs):
        assert (out == 0).all()


@pytest.mark.parametrize("name", ["hubs", "rmat8"])
def test_square_graph_is_its_own_transpose(name):
    """Without ``trans`` the graph's buckets serve the transpose role: the
    same values and gradients, bit for bit, as handing the graph in as its
    own transpose."""
    _, _, tdg, arrs = _case(name)
    for single in (False, True):
        rule = tfg._single_pass
        tfg._single_pass = lambda nv, f: single
        try:
            a = _torch_value_and_grads(
                lambda x, y, z: tfg.gat_attention_spmm_v2(tdg, x, y, z), arrs)
            b = _torch_value_and_grads(
                lambda x, y, z: tfg.gat_attention_spmm_v2(tdg, x, y, z,
                                                          trans=tdg), arrs)
        finally:
            tfg._single_pass = rule
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("name", sorted(RECT))
def test_rectangular_kernels_match_plain_on_cuda(name, single, monkeypatch):
    """The five passes on a rectangular table and its transpose, on the
    card, against the same op on the CPU (run at rmat13 by chip_smoke.py's
    sharded phase on a rank's tables)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GAT kernels have no CPU mode")
    monkeypatch.setattr(tfg, "_single_pass", lambda nv, f: single)
    fwd, trans, _, arrs = _rect(name, device="cuda")
    cfwd, ctrans, _, _ = _rect(name)
    on_card = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(
            fwd, a.cuda(), b.cuda(), x.cuda(), trans=trans).cpu(), arrs)
    on_cpu = _torch_value_and_grads(
        lambda a, b, x: tfg.gat_attention_spmm_v2(cfwd, a, b, x,
                                                  trans=ctrans), arrs)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, **GRAD)


# ---- v1: per-edge logits and weights --------------------------------------

V1_GRAPHS = {
    "hubs": (hubs_graph, 16),          # degrees 64, 65, 199, 1 and 0
    "hubs_f7": (hubs_graph, 7),
    "hubs_f33": (hubs_graph, 33),      # more float columns than lanes
    "hubs_f256": (hubs_graph, 256),    # several float4 columns a lane, tiles
    "rmat11": (lambda: add_selfloop(rmat(11, 8, seed=1)), 16),
    "rmat11_edgeless_rows": (lambda: rmat(11, 8, seed=1), 12),
}
WEIGHTS = ("mask", "positive")


def _v1_case(name, weights):
    make, f = V1_GRAPHS[name]
    g = make()
    rng = np.random.default_rng(2)
    w = ((rng.random(g.ne) < 0.6).astype(np.float32) if weights == "mask"
         else rng.random(g.ne).astype(np.float32) + 0.1)
    arrs = dict(l=rng.standard_normal(g.ne).astype(np.float32) * 2, w=w,
                x=rng.standard_normal((g.nv, f)).astype(np.float32),
                ct=rng.standard_normal((g.nv, f)).astype(np.float32))
    return (g, jdgm.to_device_graph(g, seg_ell=False),
            tdgm.to_device_graph(g, device="cpu"), arrs)


def _v1_value_and_grads(fn, arrs):
    l, w, x = (t.requires_grad_(True) for t in _t(arrs, "l", "w", "x"))
    out = fn(l, w, x)
    (out * torch.from_numpy(arrs["ct"])).sum().backward()
    return [out.detach().numpy(), l.grad.numpy(), w.grad.numpy(),
            x.grad.numpy()]


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name", sorted(V1_GRAPHS))
def test_v1_op_and_grads_match_jax(name, weights):
    """``gat_attention_spmm`` (the plain versions of its three passes on
    the CPU) against the JAX op and ``jax.grad`` of it in logits, edge_w
    and x, with a random 0/1 mask and with random positive weights."""
    _, jdg, tdg, arrs = _v1_case(name, weights)
    jl_, jw, jx, jct = _j(arrs, "l", "w", "x", "ct")
    jout = jax.jit(lambda a, b, c: jfg.gat_attention_spmm(jdg, a, b, c))(
        jl_, jw, jx)
    jgrads = jax.jit(jax.grad(
        lambda a, b, c: (jfg.gat_attention_spmm(jdg, a, b, c) * jct).sum(),
        argnums=(0, 1, 2)))(jl_, jw, jx)
    before = dict(tee.LAUNCHES)
    ours = _v1_value_and_grads(
        lambda a, b, c: tfg.gat_attention_spmm(tdg, a, b, c), arrs)
    assert tee.LAUNCHES == before      # CPU tensors launch nothing
    np.testing.assert_allclose(ours[0], np.asarray(jout), **VAL)
    for mine, theirs, what in zip(ours[1:], jgrads, ("d_l", "d_w", "d_x")):
        np.testing.assert_allclose(mine, np.asarray(theirs), err_msg=what,
                                   **GRAD)


def _v1_unfused(tdg, l, w, x):
    return spmm(tdg, segment_softmax(tdg, l) * w, x, "ell")


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name", sorted(V1_GRAPHS))
def test_v1_op_matches_the_ports_unfused_path(name, weights):
    g, _, tdg, arrs = _v1_case(name, weights)
    fused = _v1_value_and_grads(
        lambda a, b, c: tfg.gat_attention_spmm(tdg, a, b, c), arrs)
    plain = _v1_value_and_grads(lambda a, b, c: _v1_unfused(tdg, a, b, c), arrs)
    np.testing.assert_allclose(fused[0], plain[0], **VAL)
    for a, b, what in zip(fused[1:], plain[1:], ("d_l", "d_w", "d_x")):
        np.testing.assert_allclose(a, b, err_msg=what, **GRAD)
    # an edgeless row: output and gradients finite, the row's output 0
    assert all(np.isfinite(a).all() for a in fused)
    assert (fused[0][g.degrees() == 0] == 0).all()


def test_v1_masked_edges_add_exact_zeros():
    """A row whose edges are all masked out gives exact zeros even where
    its scores overflow (a row shift far below the logits): 0, not
    0 * inf."""
    _, _, tdg, arrs = _v1_case("hubs", "mask")
    l, w, x = _t(arrs, "l", "w", "x")
    row = int(torch.argmax(tdg.deg))
    lo, hi = int(tdg.row_ptr[row]), int(tdg.row_ptr[row + 1])
    w[lo:hi] = 0.0
    m, zinv = tfg._norm_consts(tdg, l)
    m[row] = -200.0
    assert torch.isinf(torch.exp(l[lo:hi] - m[row])).all()
    out = tee.gat_v1_fwd_plain(tdg, l, w, x, m, zinv)
    assert (out[row] == 0).all() and torch.isfinite(out).all()


@pytest.mark.parametrize("impl", ["ell", "auto"])
def test_apply_model_default_trivial_w_matches_jax(impl, monkeypatch):
    """``apply_model`` for GAT with the default ``trivial_w=False`` and a
    0/1 mask as edge weights on rmat13 (nv = 8192, so both strategies are
    ELL and both packages take the v1 fused attention): logits and every
    parameter's gradient. Values 2e-5, gradients 1e-4."""
    from graphaibench_tpu.nn import layers as jl
    from graphaibench_tpu.nn import model as jm
    from graphaibench_tpu_torch.nn import layers as tl
    from graphaibench_tpu_torch.nn import model as tm

    g = rmat(13, 8, seed=1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.nv, 24)).astype(np.float32)
    jcfg = jl.make_config("gat", 2, 24, 16, 4, spmm_impl=impl)
    tcfg = tl.make_config("gat", 2, 24, 16, 4, spmm_impl=impl)
    jb = jm.GraphBundle.build(g, "gat", spmm_impl=impl)
    tb = tm.GraphBundle.build(g, "gat", device="cpu", spmm_impl=impl)
    mask = (rng.random(tb.host.ne) < 0.7).astype(np.float32)
    ct = rng.standard_normal((g.nv, 4)).astype(np.float32)
    jparams = jl.init_params(jcfg)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    def jloss(p):
        out = jl.apply_model(jcfg, p, jb.device, jnp.asarray(mask),
                             jnp.asarray(x))
        return (out * jnp.asarray(ct)).sum(), out

    jgrads, jout = jax.jit(jax.grad(jloss, has_aux=True))(jparams)
    calls = []
    plain = tee.gat_v1_fwd_plain
    monkeypatch.setattr(tee, "gat_v1_fwd_plain",
                        lambda *a: (calls.append(1), plain(*a))[1])
    tout = tl.apply_model(tcfg, tparams, tb.device, torch.from_numpy(mask),
                          torch.from_numpy(x))
    assert len(calls) == 2      # the v1 forward pass, once per layer
    (tout * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **VAL)
    tgrads = {n: p.grad.numpy() for n, p in tparams.named_parameters()}
    want = {f"gconv.{l}.{k}": v for l, layer in enumerate(jgrads["gconv"])
            for k, v in layer.items()}
    want["dense.W"] = jgrads["dense"]["W"]
    assert set(want) == set(tgrads)
    for name, value in want.items():
        np.testing.assert_allclose(tgrads[name], np.asarray(value),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("name", ["hubs", "hubs_f7", "rmat11_edgeless_rows"])
def test_v1_store_or_combine_rule_matches_plain(name, weights):
    """The three new kernels' rule, emulated on the CPU: outputs NaN but
    for ``zero_rows``, an unsplit row's piece stored, a split row's pieces
    combined, only the first ``valid`` slots read (never ``vals[ne]``);
    and every edge written exactly once by ``sddmm_dot_ell``."""
    g, _, dg, arrs = _v1_case(name, weights)
    l, w, x, ct = _t(arrs, "l", "w", "x", "ct")
    f = x.shape[1]

    def per_bucket(fn):
        out = []
        for b in dg.ell:
            eid = b.edge_id.view(b.rows, b.width).long()
            live = torch.arange(b.width)[None, :] < b.valid[:, None]
            assert int(eid[live].max()) < dg.ne       # no pad id is read
            eid = torch.where(live, eid, torch.zeros_like(eid))
            out.append(fn(b.row_ids.long(), b.nbr.view(b.rows, b.width).long(),
                          eid, live))
        return out

    neg = float("-inf")
    m = _combine_rule(dg, (g.nv,), neg, per_bucket(
        lambda rows, nbr, eid, live: l[eid].masked_fill(~live, neg).amax(1)),
        _amax)
    assert torch.equal(m, tee.ell_row_reduce_plain(dg, l, "max"))
    total = _combine_rule(dg, (g.nv,), 0.0, per_bucket(
        lambda rows, nbr, eid, live: (l[eid] * live).sum(1)), _add)
    torch.testing.assert_close(total, tee.ell_row_reduce_plain(dg, l, "sum"),
                               rtol=1e-5, atol=1e-5)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = _combine_rule(dg, (g.nv,), 0.0, per_bucket(
        lambda rows, nbr, eid, live:
        (torch.exp(l[eid] - m[rows][:, None]) * live).sum(1)), _add)
    z_p = tee.ell_row_reduce_plain(dg, l, "sumexp", m)
    assert not torch.isnan(z).any()
    torch.testing.assert_close(z, z_p, rtol=1e-5, atol=1e-6)
    zinv = 1.0 / torch.clamp(z_p, min=tfg.Z_FLOOR)

    def v1_piece(rows, nbr, eid, live):
        s = (torch.exp(l[eid] - m[rows][:, None]) * zinv[rows][:, None]
             * w[eid] * live)
        return (s[:, :, None] * x[nbr]).sum(1)

    out = _combine_rule(dg, (g.nv, f), 0.0, per_bucket(v1_piece), _add)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, tee.gat_v1_fwd_plain(dg, l, w, x, m, zinv),
                               rtol=1e-5, atol=1e-6)

    raw = torch.full((dg.ne,), float("nan"))
    writes = torch.zeros(dg.ne, dtype=torch.int64)
    for b in dg.ell:
        eid = b.edge_id.view(b.rows, b.width).long()
        live = torch.arange(b.width)[None, :] < b.valid[:, None]
        d = (ct[b.row_ids.long()][:, None, :]
             * x[b.nbr.view(b.rows, b.width).long()]).sum(-1)
        raw[eid[live]] = d[live]
        writes.index_add_(0, eid[live], torch.ones_like(eid[live]))
    assert (writes == 1).all()
    torch.testing.assert_close(raw, tee.sddmm_dot_ell_plain(dg, ct, x))


def test_v1_wrappers_reject_what_the_kernels_do_not_take():
    _, _, dg, arrs = _v1_case("hubs", "mask")
    l, w, x = _t(arrs, "l", "w", "x")
    m, zinv = tfg._norm_consts(dg, l)
    with pytest.raises(ValueError, match="unknown reduction"):
        tee.ell_row_reduce(dg, l, "min")
    with pytest.raises(ValueError, match="sumexp"):
        tee.ell_row_reduce(dg, l, "sum", m)
    with pytest.raises(ValueError, match="shape"):
        tee.ell_row_reduce(dg, l[:-1], "sum")
    with pytest.raises(ValueError, match="float32"):
        tee.gat_v1_fwd(dg, l, w.double(), x, m, zinv)
    with pytest.raises(ValueError, match="shape"):
        tee.sddmm_dot_ell(dg, x, x[:, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        tee.sddmm_dot_ell(dg, x, x.t().contiguous().t())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(V1_GRAPHS))
def test_v1_kernels_match_plain_on_cuda(name):
    """The v1 op through its kernels on the card against the CPU's plain
    versions (run at full size by chip_smoke.py's kernel phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g, _, tdg, arrs = _v1_case(name, "mask")
    dg = tdgm.to_device_graph(g, device="cuda")
    card = _v1_value_and_grads(
        lambda a, b, c: tfg.gat_attention_spmm(dg, a.cuda(), b.cuda(),
                                               c.cuda()).cpu(), arrs)
    cpu = _v1_value_and_grads(
        lambda a, b, c: tfg.gat_attention_spmm(tdg, a, b, c), arrs)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(a, b, **GRAD)
