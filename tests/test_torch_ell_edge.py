"""The two wide passes over per-edge values of ``csrc/ell_edge.cu``
(``sddmm_dot_ell``, ``gat_v1_fwd``), as far as the CPU reaches them.

The kernels run on the card only, so their lane and slot arithmetic is
emulated here with numpy, 32 lanes at a time, index for index as the source
has it: the transposing butterfly that leaves every slot's dot product in
the lane that stores it, the warp's loop bound over rows of different
lengths, the rounds in which the lanes of ``gat_v1_fwd`` prepare one slot
each and hand ids and coefficients on by shuffles, and the scores it
writes for the backward. The chunk sizes and the lane rule are read from
the source's own ``#define`` lines. The emulations are held against the
plain PyTorch versions (rtol = atol = 1e-5: float64 sums here against
float32 there), and the plain versions and the v1 op against the JAX
package at F = 256, 33 and 12 (values 2e-5, gradients 1e-4, as in
tests/test_torch_fused_gat.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.transforms import add_selfloop
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.ops import fused_gat as jfg
from graphaibench_tpu.ops import segment as jseg
from graphaibench_tpu.ops.spmm import sddmm_dot as jax_sddmm_dot
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import ell_edge as tee
from graphaibench_tpu_torch.ops import fused_gat as tfg
from graphaibench_tpu_torch.ops.segment import segment_softmax
from graphaibench_tpu_torch.ops.spmm import spmm
from test_torch_device_graph import hubs_graph

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
WARP = 32
LANES = np.arange(WARP)

_SOURCE = (_build.CSRC / "ell_edge.cu").read_text()


def _define(name: str) -> int:
    """The source's own value of a build-time constant."""
    return int(re.search(rf"#define {name} (\d+)", _SOURCE).group(1))


V1_CHUNK_LG = _define("GAB_V1_CHUNK_LG")
V1_NARROW_CHUNK_LG = _define("GAB_V1_NARROW_CHUNK_LG")
DOT_CHUNK_LG = _define("GAB_DOT_CHUNK_LG")
DOT_COLS = _define("GAB_DOT_COLS")
DOT_LANES_LG = _define("GAB_DOT_LANES_LG")

GRAPHS = {
    "hubs": hubs_graph,                 # degrees 64, 65, 199, 1 and 0
    "rmat8": lambda: add_selfloop(rmat(8, 8, seed=3)),
}


def _columns(x: torch.Tensor):
    """(nv, columns of V, floats of a column) as float64: float4 columns
    where F % 4 == 0, as the wrappers choose, else float."""
    nv, f = x.shape
    vw = 4 if f % 4 == 0 else 1
    return x.numpy().astype(np.float64).reshape(nv, f // vw, vw)


def _bucket_arrays(b):
    return (b.row_ids.numpy(), b.nbr.view(b.rows, b.width).numpy(),
            b.edge_id.view(b.rows, b.width).numpy(), b.valid.numpy())


def _warps(b, lg: int):
    """Per warp of a bucket's blocks: each lane's virtual row (clamped
    where the lane is past the bucket's end) and slot count (0 there). A
    block holds 256 >> lg consecutive rows, so its warps do."""
    valid = b.valid.numpy()
    for r0 in range(0, b.rows, WARP >> lg):
        r = r0 + (LANES >> lg)
        live = r < b.rows
        r = np.minimum(r, b.rows - 1)
        yield r, np.where(live, valid[r], 0)


# ---- the transposing butterfly --------------------------------------------

def _butterfly(d: np.ndarray, lg: int, chunk_lg: int):
    """``transpose_sum`` on a warp: d is (32 lanes, chunk) partial sums;
    returns what every lane holds afterwards and the shuffles it took."""
    d = d.copy()
    chunk = 1 << chunk_lg
    t = min(lg, chunk_lg)
    shuffles = 0
    for s in range(t):
        odd = ((LANES >> s) & 1) != 0
        across = LANES ^ (1 << s)
        for i in range(chunk >> (s + 1)):
            mine = np.where(odd, d[:, 2 * i + 1], d[:, 2 * i])
            theirs = np.where(odd, d[:, 2 * i], d[:, 2 * i + 1])
            d[:, i] = mine + theirs[across]
            shuffles += 1
    for s in range(t, lg):
        d[:, 0] = d[:, 0] + d[LANES ^ (1 << s), 0]
        shuffles += 1
    return d, shuffles


@pytest.mark.parametrize("chunk_lg", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("lg", [0, 1, 2, 3, 4, 5])
def test_butterfly_leaves_each_slot_in_the_lane_that_stores_it(lg, chunk_lg):
    """For every group size (1 to 32 lanes) and chunk: after the butterfly
    lane gl holds in d[i] the whole group's sum for slot
    i 2^T + (gl mod 2^T), T = min(lg, chunk_lg); the lanes that store
    (all of them, or the first ``chunk`` of a larger group) cover every
    slot of the chunk exactly once."""
    rng = np.random.default_rng(lg * 8 + chunk_lg)
    chunk, g, t = 1 << chunk_lg, 1 << lg, min(lg, chunk_lg)
    d = rng.standard_normal((WARP, chunk))
    got, shuffles = _butterfly(d, lg, chunk_lg)
    total = d.reshape(WARP // g, g, chunk).sum(1)      # (group, slot)
    gl = LANES & (g - 1)
    owner = (lg <= chunk_lg) | (gl < chunk)
    covered = np.zeros((WARP // g, chunk), np.int64)
    for i in range(chunk >> t):
        slot = (i << t) + (gl & ((1 << t) - 1))
        np.testing.assert_allclose(got[:, i], total[LANES >> lg, slot],
                                   rtol=1e-12, atol=1e-12)
        np.add.at(covered, ((LANES >> lg)[owner], slot[owner]), 1)
    assert (covered == 1).all()
    # C - 1 exchanges while values remain to hand over, then one per bit
    assert shuffles == (chunk - (chunk >> t)) + (lg - t)
    if (lg, chunk_lg) == (5, 3):
        assert shuffles == 9          # against 40 for 8 slots, one by one


# ---- sddmm_dot_ell ----------------------------------------------------------

def _dot_lanes_lg(f_v: int) -> int:
    """The C entry's rule: the smallest group that covers the columns of
    V, at most 2^DOT_LANES_LG lanes."""
    lg = 0
    while lg < DOT_LANES_LG and (1 << lg) < f_v:
        lg += 1
    return lg


def _emulate_sddmm(dg, a, b, lg: int, chunk_lg: int, cols: int):
    """(raw, writes per edge) as the kernel computes them."""
    av, bv = _columns(a), _columns(b)
    f_v = av.shape[1]
    g, chunk, t = 1 << lg, 1 << chunk_lg, min(lg, chunk_lg)
    gl = LANES & (g - 1)
    owner = (lg <= chunk_lg) | (gl < chunk)
    raw = np.full(dg.ne, np.nan)
    writes = np.zeros(dg.ne, np.int64)
    passes = max(cols, -(-f_v // g))    # registers first, then re-read
    for bk in dg.ell:
        row_ids, nbr, eid, _ = _bucket_arrays(bk)
        for r, cnt in _warps(bk, lg):
            for j0 in range(0, int(cnt.max()), chunk):   # the warp's bound
                d = np.zeros((WARP, chunk))
                for k in range(chunk):
                    real = j0 + k < cnt
                    j = np.minimum(j0 + k, bk.width - 1)
                    assert (eid[r[real], j] != dg.ne).all()   # no pad read
                    ids = nbr[r, j]
                    for q in range(passes):
                        c = gl + q * g
                        on = real & (c < f_v)
                        cc = np.minimum(c, f_v - 1)
                        d[:, k] += np.where(on, (av[row_ids[r], cc]
                                                 * bv[ids, cc]).sum(-1), 0.0)
                d, _ = _butterfly(d, lg, chunk_lg)
                for i in range(chunk >> t):
                    j = j0 + (i << t) + (gl & ((1 << t) - 1))
                    st = owner & (j < cnt)
                    e = eid[r[st], j[st]]
                    raw[e] = d[st, i]
                    np.add.at(writes, e, 1)
    return raw, writes


def _ab(g, f):
    rng = np.random.default_rng(11)
    return (torch.from_numpy(rng.standard_normal((g.nv, f)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((g.nv, f)).astype(np.float32)))


# F: 16 and 128 (the main path's), 12 (three columns of V: a group with an
# idle lane), 33 and 7 (float columns; 33 more columns than the widest
# group has lanes), 256 (more float4 columns than registers hold)
@pytest.mark.parametrize("f", [16, 128, 12, 33, 7, 256])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sddmm_emulation_writes_every_edge_once_and_matches_plain(name, f):
    g = GRAPHS[name]()
    dg = tdgm.to_device_graph(g, device="cpu")
    a, b = _ab(g, f)
    f_v = f // 4 if f % 4 == 0 else f
    raw, writes = _emulate_sddmm(dg, a, b, _dot_lanes_lg(f_v), DOT_CHUNK_LG,
                                 DOT_COLS)
    assert (writes == 1).all()
    np.testing.assert_allclose(raw, tee.sddmm_dot_ell_plain(dg, a, b).numpy(),
                               **TOL)


@pytest.mark.parametrize("lg,chunk_lg,cols", [
    (5, 3, 1), (5, 2, 1), (3, 3, 4), (4, 4, 2), (2, 4, 1), (0, 3, 4), (1, 0, 1)])
def test_sddmm_emulation_holds_for_every_build_time_choice(lg, chunk_lg, cols):
    """The group may be smaller than the columns of V and than the chunk,
    or larger than both."""
    g = hubs_graph()
    dg = tdgm.to_device_graph(g, device="cpu")
    a, b = _ab(g, 40)                   # ten float4 columns
    raw, writes = _emulate_sddmm(dg, a, b, lg, chunk_lg, cols)
    assert (writes == 1).all()
    np.testing.assert_allclose(raw, tee.sddmm_dot_ell_plain(dg, a, b).numpy(),
                               **TOL)


def test_emulated_graphs_have_the_hard_rows():
    """What the emulations above must meet: rows whose slot count is no
    multiple of the chunk, and warps whose rows differ in length."""
    dg = tdgm.to_device_graph(hubs_graph(), device="cpu")
    chunk = 1 << DOT_CHUNK_LG
    valid = torch.cat([b.valid for b in dg.ell]).numpy()
    assert (valid % chunk != 0).any() and (valid % chunk == 0).any()
    dg = tdgm.to_device_graph(GRAPHS["rmat8"](), device="cpu")
    uneven = 0
    for b in dg.ell:
        for _, cnt in _warps(b, 2):
            uneven += len(set(cnt[cnt > 0].tolist())) > 1
    assert uneven > 0


# ---- gat_v1_fwd -------------------------------------------------------------

def _v1_inputs(g, f, weights="mask"):
    rng = np.random.default_rng(5)
    w = ((rng.random(g.ne) < 0.6).astype(np.float32) if weights == "mask"
         else rng.random(g.ne).astype(np.float32) + 0.1)
    return dict(l=rng.standard_normal(g.ne).astype(np.float32) * 2, w=w,
                x=rng.standard_normal((g.nv, f)).astype(np.float32),
                ct=rng.standard_normal((g.nv, f)).astype(np.float32))


def _emulate_v1(dg, logits, edge_w, x, m, zinv, tile_v: int):
    """(out, scores, score writes per edge) as the kernel computes them,
    for ``tile_v`` columns of V a tile."""
    xv = _columns(x)
    nv, f_v, vw = xv.shape
    lg = 0
    while (1 << lg) < tile_v:
        lg += 1
    g = 1 << lg
    chunk = 1 << (V1_NARROW_CHUNK_LG if lg <= 2 else V1_CHUNK_LG)
    prep = 1 if g >= chunk else chunk // g
    rnd = g * prep
    gl = LANES & (g - 1)
    base = LANES - gl                     # first lane of each group
    l64, w64 = logits.numpy().astype(np.float64), edge_w.numpy()
    m64, z64 = m.numpy().astype(np.float64), zinv.numpy().astype(np.float64)
    out = np.zeros((nv, f_v, vw))
    scores = np.full(dg.ne, np.nan)
    writes = np.zeros(dg.ne, np.int64)
    for tile in range(-(-f_v // tile_v)):
        col = tile * tile_v + gl
        for bk in dg.ell:
            row_ids, nbr, eid, _ = _bucket_arrays(bk)
            for r, cnt in _warps(bk, lg):
                active = (cnt > 0) & (gl < tile_v) & (col < f_v)
                cc = np.minimum(col, f_v - 1)
                row = row_ids[r]
                acc = np.zeros((WARP, vw))
                top = int(cnt.max())
                for j0 in range(0, top, rnd):
                    my_id = np.full((WARP, prep), -1)
                    my_c = np.zeros((WARP, prep))
                    for q in range(prep):       # one lane, one slot
                        j = j0 + q * g + gl
                        real = j < cnt
                        jj = np.minimum(j, bk.width - 1)
                        e = eid[r, jj]
                        assert (e[real] != dg.ne).all()       # no pad read
                        e = np.where(real, e, 0)
                        s = np.exp(l64[e] - m64[row]) * z64[row]
                        my_id[:, q] = np.where(real, nbr[r, jj], -1)
                        my_c[:, q] = np.where(real & (w64[e] != 0),
                                              s * w64[e], 0.0)
                        if tile == 0:
                            scores[e[real]] = s[real]
                            np.add.at(writes, e[real], 1)
                    for c0 in range(0, rnd, chunk):
                        if j0 + c0 >= top:
                            break
                        for k in range(chunk):
                            if prep == 1:
                                src, q = base + c0 + k, 0
                            else:
                                src, q = base + (k & (g - 1)), k >> lg
                            ids, coef = my_id[src, q], my_c[src, q]
                            # what arrives is slot j0 + c0 + k of the lane's
                            # own row, or nothing past its end
                            j = j0 + c0 + k
                            want = np.where(j < cnt,
                                            nbr[r, min(j, bk.width - 1)], -1)
                            assert (ids == want).all()
                            on = active & (ids >= 0)
                            acc += np.where(
                                on[:, None],
                                coef[:, None] * xv[np.maximum(ids, 0), cc], 0.0)
                np.add.at(out, (row[active], cc[active]), acc[active])
    return out.reshape(nv, -1), scores, writes


# (F, tile_v): 16 -> a group of four lanes, each preparing several slots;
# 12 -> three columns in a group of four; 7 and 33 -> float columns, 33 in
# two tiles; 128 -> one slot a lane, four chunks a round; 256 -> two tiles
@pytest.mark.parametrize("f,tile_v", [(16, 4), (12, 3), (7, 7), (33, 32),
                                      (128, 32), (128, 16), (256, 32)])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_v1_emulation_matches_plain_and_writes_each_score_once(name, f, tile_v):
    g = GRAPHS[name]()
    dg = tdgm.to_device_graph(g, device="cpu")
    arrs = _v1_inputs(g, f)
    l, w, x = (torch.from_numpy(arrs[k]) for k in ("l", "w", "x"))
    m, zinv = tfg._norm_consts(dg, l)
    out, scores, writes = _emulate_v1(dg, l, w, x, m, zinv, tile_v)
    want, want_scores = tee.gat_v1_fwd_plain(dg, l, w, x, m, zinv, True)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, want.numpy(), **TOL)
    np.testing.assert_allclose(scores, want_scores.numpy(), **TOL)


def test_v1_tile_rule_is_its_own():
    """gat_v1_fwd's feature tile does not follow v2's rule."""
    class _T:
        def data_ptr(self):
            return 256

    for nv, f in ((1 << 17, 128), (1 << 19, 128), (1 << 17, 16), (1 << 10, 256)):
        tile_v, vec, tiles = tee._wide_shape(
            nv, f, _T(), tile_floats=tee._v1_tile_floats)
        assert vec == 1 and tile_v == tee._v1_tile_floats(nv, f) // 4
        assert 1 <= tile_v <= 32 and tiles * tile_v >= f // 4
    # the shape takes the rule it is given
    assert tee._wide_shape(1 << 17, 128, _T(),
                           tile_floats=lambda nv, f: 64) == (16, 1, 2)


# ---- the scores, and the plain versions against the JAX package -------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plain_scores_are_the_row_softmax(name):
    g = GRAPHS[name]()
    dg = tdgm.to_device_graph(g, device="cpu")
    jdg = jdgm.to_device_graph(g, seg_ell=False)
    arrs = _v1_inputs(g, 8)
    l, w, x = (torch.from_numpy(arrs[k]) for k in ("l", "w", "x"))
    m, zinv = tfg._norm_consts(dg, l)
    out, scores = tee.gat_v1_fwd(dg, l, w, x, m, zinv, True)
    assert not torch.isnan(scores).any()          # every edge has a slot
    assert torch.equal(out, tee.gat_v1_fwd(dg, l, w, x, m, zinv))
    np.testing.assert_allclose(scores.numpy(),
                               segment_softmax(dg, l).numpy(), **TOL)
    np.testing.assert_allclose(
        scores.numpy(),
        np.asarray(jseg.segment_softmax(jdg, jnp.asarray(arrs["l"]))), **TOL)


WIDTHS = (256, 33, 12)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sddmm_dot_plain_matches_jax_at_other_widths(name, f):
    g = GRAPHS[name]()
    dg = tdgm.to_device_graph(g, device="cpu")
    jdg = jdgm.to_device_graph(g, seg_ell=False)
    a, b = _ab(g, f)
    want = jax_sddmm_dot(jdg, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    got = tee.sddmm_dot_ell(dg, a, b)
    assert not torch.isnan(got).any()
    # |<a, b>| grows with sqrt(F); float32 sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(1.0, f / 16))


def _v1_value_and_grads(fn, arrs):
    l, w, x = (torch.from_numpy(arrs[k]).requires_grad_(True)
               for k in ("l", "w", "x"))
    out = fn(l, w, x)
    (out * torch.from_numpy(arrs["ct"])).sum().backward()
    return [out.detach().numpy(), l.grad.numpy(), w.grad.numpy(),
            x.grad.numpy()]


@pytest.mark.parametrize("weights", ["mask", "positive"])
@pytest.mark.parametrize("f", WIDTHS)
def test_v1_op_and_grads_match_jax_at_other_widths(f, weights):
    """``gat_attention_spmm``, whose backward reads the scores its forward
    pass wrote, against the JAX op and ``jax.grad`` of it, and against the
    port's unfused path."""
    g = hubs_graph()
    dg = tdgm.to_device_graph(g, device="cpu")
    jdg = jdgm.to_device_graph(g, seg_ell=False)
    arrs = _v1_inputs(g, f, weights)
    jl_, jw, jx, jct = (jnp.asarray(arrs[k]) for k in ("l", "w", "x", "ct"))
    jout = jax.jit(lambda a, b, c: jfg.gat_attention_spmm(jdg, a, b, c))(
        jl_, jw, jx)
    jgrads = jax.jit(jax.grad(
        lambda a, b, c: (jfg.gat_attention_spmm(jdg, a, b, c) * jct).sum(),
        argnums=(0, 1, 2)))(jl_, jw, jx)
    ours = _v1_value_and_grads(
        lambda a, b, c: tfg.gat_attention_spmm(dg, a, b, c), arrs)
    plain = _v1_value_and_grads(
        lambda a, b, c: spmm(dg, segment_softmax(dg, a) * b, c, "ell"), arrs)
    np.testing.assert_allclose(ours[0], np.asarray(jout), **VAL)
    np.testing.assert_allclose(ours[0], plain[0], **VAL)
    for mine, theirs, other, what in zip(ours[1:], jgrads, plain[1:],
                                         ("d_l", "d_w", "d_x")):
        np.testing.assert_allclose(mine, np.asarray(theirs), err_msg=what,
                                   **GRAD)
        np.testing.assert_allclose(mine, other, err_msg=what, **GRAD)


def test_v1_forward_writes_no_scores_where_no_gradient_is_wanted(monkeypatch):
    """Without a gradient to compute the op asks the pass for the output
    alone; with one, for the scores too, and saves them in place of the
    logits and the normalizers."""
    g = hubs_graph()
    dg = tdgm.to_device_graph(g, device="cpu")
    arrs = _v1_inputs(g, 8)
    l, w, x = (torch.from_numpy(arrs[k]) for k in ("l", "w", "x"))
    asked = []
    fwd = tfg.gat_v1_fwd
    monkeypatch.setattr(tfg, "gat_v1_fwd",
                        lambda *a: (asked.append(len(a) == 7 and a[6]),
                                    fwd(*a))[1])
    quiet = tfg.gat_attention_spmm(dg, l, w, x)
    with torch.no_grad():
        tfg.gat_attention_spmm(dg, l.clone().requires_grad_(True), w, x)
    loud = tfg.gat_attention_spmm(dg, l.clone().requires_grad_(True), w, x)
    assert asked == [False, False, True]
    assert torch.equal(quiet, loud.detach())
    assert [tuple(t.shape) for t in loud.grad_fn.saved_tensors] == [
        (g.ne,), (g.nv, 8), (g.ne,)]
