"""The pull step of the analytics solvers, ``neighbor_reduce`` (kernel in
``csrc/ell_pull.cu``, wrapper and plain version in ``ops/ell_pull.py``),
held against the JAX package's ``ops/segment.py::neighbor_reduce``.

Inputs are made with numpy from a seed and fed to both packages, on graphs
built by each package's own generators from the same parameters (and held
equal here). Tolerances: min, max and int32 sums exact (integer adds wrap
in any order); float32 sums rtol 1e-5 and atol 1e-6, the JAX package's own
tolerance for its reordered sums (tests/test_pull_mode.py). The kernel runs
on the card only: its lane and slot arithmetic (four lanes a row, two int4
of ids a lane a step, the row's count masking the pads) is emulated here
with numpy, with the constants read from the source, and held against the
plain version exactly; chip_smoke.py holds the kernel itself against the
plain version at rmat19.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.ops import segment as jseg
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import ell_pull
from graphaibench_tpu_torch.ops.segment import (
    neighbor_reduce,
    pack_neighbor_edge_vals,
)

torch.set_num_threads(2)

FSUM = dict(rtol=1e-5, atol=1e-6)

_SOURCE = (_build.CSRC / "ell_pull.cu").read_text()
PULL_LG = int(re.search(r"constexpr int kPullLg = (\d+);", _SOURCE).group(1))
PULL_QUADS = int(re.search(r"constexpr int kPullQuads = (\d+);",
                           _SOURCE).group(1))


def _pair(build):
    """(port graph, JAX graph) of one graph recipe applied to both packages'
    modules; their arrays must be equal."""
    t = build(tgen, T, tcsr)
    j = build(jgen, JT, jcsr)
    assert np.array_equal(t.row_ptr, j.row_ptr)
    assert np.array_equal(t.col_idx, j.col_idx)
    return t, j


def _disconnected(gen, tr, csr):
    """Two rmat pieces side by side and isolated vertices after them."""
    a = gen.rmat(6, 4, seed=5)
    src, dst = a.coo()
    n = a.nv
    return tr.sort_and_clean(tr.symmetrize(csr.from_edges(
        np.r_[src, src + n], np.r_[dst, dst + n], 2 * n + 9)))


GRAPHS = {
    "rmat8": lambda gen, tr, csr: tr.sort_and_clean(tr.symmetrize(
        gen.rmat(8, 6, seed=11))),
    "rmat12": lambda gen, tr, csr: tr.sort_and_clean(tr.symmetrize(
        gen.rmat(12, 12, seed=3))),                 # split rows (degree > 64)
    "uniform": lambda gen, tr, csr: tr.sort_and_clean(
        gen.uniform_random(300, 1200, seed=9)),
    "grid24": lambda gen, tr, csr: gen.grid2d(24),
    "disconnected": _disconnected,
}

_CACHE = {}


def _case(name):
    """(port graph, port device graph, JAX device graph)."""
    if name not in _CACHE:
        t, j = _pair(GRAPHS[name])
        _CACHE[name] = (t, tdgm.to_device_graph(t, device="cpu"),
                        jdgm.to_device_graph(j, with_transpose=True,
                                             with_ell=True))
    return _CACHE[name]


def _vals(nv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-10**6, 10**6, nv).astype(np.int32)
    return rng.standard_normal(nv).astype(np.float32)


def _edge_vals(ne, seed=1):
    return np.random.default_rng(seed).random(ne).astype(np.float32) + 0.25


CASES = [(dt, kind, ev) for dt in ("int32", "float32")
         for kind in ("min", "max", "sum")
         for ev in (("none",) if dt == "int32" else ("none", "packed", "flat"))]


def _assert_matches(got, want, kind, dtype):
    assert got.dtype == want.dtype
    if kind == "sum" and dtype == "float32":
        np.testing.assert_allclose(got, want, **FSUM)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,kind,ev", CASES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_neighbor_reduce_matches_jax(name, dtype, kind, ev):
    g, dg, jdg = _case(name)
    v = _vals(g.nv, dtype)
    e = _edge_vals(g.ne)
    if ev == "none":
        t_ev, j_ev = None, None
    elif ev == "packed":
        t_ev = pack_neighbor_edge_vals(dg, torch.from_numpy(e), kind)
        j_ev = jseg.pack_neighbor_edge_vals(jdg, jnp.asarray(e), kind)
    else:
        t_ev, j_ev = torch.from_numpy(e), jnp.asarray(e)
    got = neighbor_reduce(dg, torch.from_numpy(v), kind, t_ev).numpy()
    want = np.asarray(jseg.neighbor_reduce(jdg, jnp.asarray(v), kind, j_ev))
    _assert_matches(got, want, kind, dtype)
    # the identity on edgeless rows
    empty = g.degrees() == 0
    assert np.all(got[empty] == ell_pull.identity(kind, getattr(torch, dtype)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pack_neighbor_edge_vals_bit_equal(name):
    g, dg, jdg = _case(name)
    e = _edge_vals(g.ne, seed=4)
    got = pack_neighbor_edge_vals(dg, torch.from_numpy(e))
    want = jseg.pack_neighbor_edge_vals(jdg, jnp.asarray(e))
    assert len(got) == len(want) == len(dg.ell)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy().view(np.uint32),
                              np.asarray(b).view(np.uint32))


# ---- the kernel's slot arithmetic, emulated --------------------------------

def _emulate(dg, vals, kind, slots=None):
    """neighbor_reduce as csrc/ell_pull.cu computes it: per virtual row,
    2^kPullLg lanes; lane gl reads the int4 of ids at slots
    4 gl + 4 2^kPullLg u + step s (u < kPullQuads) up to the bucket's width,
    gathers the slots below the row's count and takes the identity for the
    others; the lanes are combined by the shuffle tree; a split row is
    combined into an identity-filled output, any other row stored. Each
    slot below the width must be read exactly once."""
    ident = ell_pull.identity(kind, vals.dtype)
    red = {"min": min, "max": max, "sum": lambda a, b: a + b}[kind]
    vals = vals.numpy()
    out = np.empty(dg.nv, vals.dtype)
    out[dg.zero_rows.numpy()] = ident
    split = dg.is_split.numpy()
    lanes = 1 << PULL_LG
    step = 4 * PULL_QUADS << PULL_LG
    for i, b in enumerate(dg.ell):
        nbr = b.nbr.numpy().reshape(b.rows, b.width)
        ev = None if slots is None else slots[i].numpy().reshape(b.rows, b.width)
        for r, (row, cnt) in enumerate(zip(b.row_ids.numpy(), b.valid.numpy())):
            seen = np.zeros(b.width, int)
            lane_v = []
            for gl in range(lanes):
                v = ident
                for j0 in range(4 * gl, b.width, step):
                    for u in range(PULL_QUADS):
                        j = j0 + 4 * lanes * u
                        if j >= b.width:
                            continue
                        for t in range(4):
                            seen[j + t] += 1
                            if j + t < cnt:
                                x = vals[nbr[r, j + t]]
                                if ev is not None:
                                    e = ev[r, j + t]
                                    x = x * e if kind == "sum" else x + e
                                v = red(v, x)
                lane_v.append(v)
            assert np.all(seen == 1), (b.width, seen)
            o = lanes >> 1
            while o:                                   # __shfl_xor_sync tree
                lane_v = [red(lane_v[l], lane_v[l ^ o]) for l in range(lanes)]
                o >>= 1
            out[row] = red(out[row], lane_v[0]) if split[row] else lane_v[0]
    return torch.from_numpy(out)


@pytest.mark.parametrize("dtype,kind,ev", [
    ("int32", "min", "none"), ("int32", "sum", "none"),
    ("float32", "max", "none"), ("float32", "min", "packed"),
    ("float32", "sum", "packed")])
@pytest.mark.parametrize("name", ["rmat12", "disconnected"])
def test_kernel_slot_arithmetic_matches_plain(name, dtype, kind, ev):
    _, dg, _ = _case(name)
    v = torch.from_numpy(_vals(dg.nv, dtype, seed=7))
    slots = (pack_neighbor_edge_vals(dg, torch.from_numpy(_edge_vals(dg.ne)))
             if ev == "packed" else None)
    got = _emulate(dg, v, kind, slots)
    want = ell_pull.neighbor_reduce_plain(dg, v, kind, slots)
    if kind == "sum" and dtype == "float32":
        torch.testing.assert_close(got, want, **FSUM)
    else:
        assert torch.equal(got, want)


# ---- what the wrapper refuses ----------------------------------------------

def test_refuses_int32_with_edge_values():
    g, dg, _ = _case("rmat8")
    e = torch.from_numpy(_edge_vals(g.ne))
    v = torch.from_numpy(_vals(g.nv, "int32"))
    for ev in (e, pack_neighbor_edge_vals(dg, e)):
        with pytest.raises(ValueError, match="float32 vals only"):
            neighbor_reduce(dg, v, "min", ev)


def test_refuses_a_graph_without_buckets():
    g, _, _ = _case("rmat8")
    dg = tdgm.to_device_graph(g, device="cpu", with_ell=False)
    assert dg.ell == () and dg.trans_perm is not None
    with pytest.raises(ValueError, match="ELL buckets"):
        neighbor_reduce(dg, torch.zeros(g.nv), "min")
    edgeless = tdgm.to_device_graph(tcsr.from_edges([], [], 5), device="cpu")
    with pytest.raises(ValueError, match="ELL buckets"):
        neighbor_reduce(edgeless, torch.zeros(5), "sum")


@pytest.mark.parametrize("bad", ["int64", "float64", "short", "2d",
                                 "strided", "kind", "ev_len", "ev_shape",
                                 "ev_dtype"])
def test_refuses_bad_operands(bad):
    g, dg, _ = _case("rmat8")
    v = torch.from_numpy(_vals(g.nv, "float32"))
    e = torch.from_numpy(_edge_vals(g.ne))
    packed = pack_neighbor_edge_vals(dg, e)
    kind, ev = "min", None
    if bad == "int64":
        v = v.long()
    elif bad == "float64":
        v = v.double()
    elif bad == "short":
        v = v[:-1]
    elif bad == "2d":
        v = v[:, None]
    elif bad == "strided":
        v = torch.stack([v, v], 1)[:, 0]
    elif bad == "kind":
        kind = "prod"
    elif bad == "ev_len":
        ev = packed[:-1]
    elif bad == "ev_shape":
        ev = e[:-1]
    else:
        ev = tuple(p.double() for p in packed)
    with pytest.raises(ValueError):
        neighbor_reduce(dg, v, kind, ev)


def test_without_transpose_and_ell_the_trainer_layout_is_unchanged():
    """The two keywords of to_device_graph leave the default graph as it
    was and drop only what they name."""
    g, dg, _ = _case("rmat12")
    for kw in ({"with_transpose": False}, {"with_ell": False}):
        other = tdgm.to_device_graph(g, device="cpu", **kw)
        for f in ("row_ptr", "col_idx", "edge_src", "deg", "is_split",
                  "zero_rows"):
            assert torch.equal(getattr(other, f), getattr(dg, f)), f
        assert (other.trans_perm is None) == ("with_transpose" in kw)
        assert (other.ell == ()) == ("with_ell" in kw)
    assert dg.trans_perm is not None and len(dg.ell) == 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kind,ev", CASES)
def test_kernel_matches_plain_on_cuda(dtype, kind, ev):
    """The kernel against its plain version on the card (run at rmat19 by
    chip_smoke.py's analytics phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: neighbor_reduce's kernel has no "
                    "CPU mode")
    g, dg, _ = _case("rmat12")
    dgc = tdgm.to_device_graph(g, device="cuda")
    v = torch.from_numpy(_vals(g.nv, dtype))
    e = torch.from_numpy(_edge_vals(g.ne))
    t_ev = {"none": None, "flat": e,
            "packed": pack_neighbor_edge_vals(dg, e)}[ev]
    c_ev = (None if t_ev is None else e.cuda() if ev == "flat"
            else tuple(p.cuda() for p in t_ev))
    got = neighbor_reduce(dgc, v.cuda(), kind, c_ev).cpu()
    want = neighbor_reduce(dg, v, kind, t_ev)
    if kind == "sum" and dtype == "float32":
        torch.testing.assert_close(got, want, **FSUM)
    else:
        assert torch.equal(got, want)
