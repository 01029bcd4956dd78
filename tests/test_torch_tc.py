"""The port's triangle counting (``graphaibench_tpu_torch/analytics/tc.py``,
the kernel K9 ``tc_count`` of ``csrc/tc_count.cu`` with its wrapper and
plain version in ``ops/tc_count.py``) and the DAG orientation it runs on
(``graph/transforms.py::orientation``, ``native.orientation``), held against
the JAX package on the CPU.

Graphs are built by each package's own generators from the same parameters
and held equal here. Counts are integers and must be equal: the port's
against the JAX package's and the serial verifier's. On the CPU
``tc_count`` takes its plain version, the JAX package's compare-all; the
kernel's arithmetic (its blocks, lane groups and binary searches over
``dag_edges``'s layout) is emulated in numpy from the constants of its
source, and the kernel itself runs on the card in ``chip_smoke.py``'s
analytics phase and in the test marked ``cuda``.
"""

import re

import numpy as np
import pytest
import torch

from graphaibench_tpu.analytics import tc as JTC
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu_torch import native as tnative
from graphaibench_tpu_torch.analytics import tc as TC
from graphaibench_tpu_torch.analytics import triangle_count
from graphaibench_tpu_torch.analytics import verifiers as TV
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import tc_count as K9
from test_torch_sampler import jax_native  # noqa: F401

torch.set_num_threads(2)

_SOURCE = (_build.CSRC / "tc_count.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SOURCE).group(1))
GROUPS = int(re.search(r"constexpr int kGroups = (\d+);", _SOURCE).group(1))


def _unsorted(gen, tr, csr):
    """rmat(9, 8) with every row's neighbours in a seeded random order."""
    g = gen.rmat(9, 8, seed=1)
    col = g.col_idx.copy()
    rng = np.random.default_rng(3)
    for v in range(g.nv):
        lo, hi = g.row_ptr[v], g.row_ptr[v + 1]
        col[lo:hi] = rng.permutation(col[lo:hi])
    return csr.CSRGraph(row_ptr=g.row_ptr.copy(), col_idx=col)


def _star_cycle(gen, tr, csr):
    """A cycle of 12 and a star of 9 leaves: edges, no triangle."""
    cyc = np.arange(12)
    src = np.r_[cyc, np.zeros(9, np.int64) + 12]
    dst = np.r_[(cyc + 1) % 12, np.arange(13, 22)]
    return tr.symmetrize(csr.from_edges(src, dst, 22))


GRAPHS = {
    "uniform": lambda gen, tr, csr: gen.uniform_random(150, 500, seed=9),
    "rmat8": lambda gen, tr, csr: gen.rmat(8, 8, seed=4),
    "rmat12": lambda gen, tr, csr: gen.rmat(12, 16, seed=2),
    "edgeless": lambda gen, tr, csr: csr.from_edges([], [], 9),
    "no_triangles": _star_cycle,
    "unsorted": _unsorted,
}

_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        t = GRAPHS[name](tgen, T, tcsr)
        j = GRAPHS[name](jgen, JT, jcsr)
        assert np.array_equal(t.row_ptr, j.row_ptr)
        assert np.array_equal(t.col_idx, j.col_idx)
        _CACHE[name] = (t, j)
    return _CACHE[name]


def _same_csr(a, b):
    assert a.row_ptr.dtype == b.row_ptr.dtype
    assert a.col_idx.dtype == b.col_idx.dtype
    assert np.array_equal(a.row_ptr, b.row_ptr)
    assert np.array_equal(a.col_idx, b.col_idx)


# ---- orientation -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_orientation_bit_equal_numpy_route(name):
    g, jg = _pair(name)
    assert g.ne < 1 << 18
    _same_csr(T.orientation(g), JT.orientation(jg))


def test_orientation_bit_equal_native_route(jax_native):
    """rmat(14, 16) crosses 2^18 edges: both packages take their C++
    orientation, and the numpy route gives the same DAG."""
    g, jg = tgen.rmat(14, 16, seed=0), jgen.rmat(14, 16, seed=0)
    assert g.ne >= 1 << 18 and tnative.available()
    dag = T.orientation(g)
    _same_csr(dag, JT.orientation(jg))
    src, dst = g.coo()
    deg = g.degrees()
    keep = (deg[dst] > deg[src]) | ((deg[dst] == deg[src]) & (dst > src))
    _same_csr(dag, tcsr.from_edges(src[keep], dst[keep], g.nv,
                                   sort_neighbors=False))
    rp, ci = tnative.orientation(g.row_ptr, g.col_idx)
    jrp, jci = jax_native.orientation(jg.row_ptr, jg.col_idx)
    assert np.array_equal(rp, jrp) and np.array_equal(ci, jci)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_degree_histogram_equals_jax(name):
    g, jg = _pair(name)
    for bins in (0, 40):
        a, b = T.degree_histogram(g, bins), JT.degree_histogram(jg, bins)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---- the solver ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_triangle_count_matches_jax_and_serial(name):
    g, jg = _pair(name)
    n = triangle_count(g, device="cpu")
    assert type(n) is int
    assert n == JTC.triangle_count(jg)
    assert n == TV.triangle_count_serial(T.orientation(g))
    if name == "no_triangles":
        assert g.ne > 0 and n == 0
    # a second call is served from the cached device state
    assert triangle_count(g, device="cpu") == n


def test_unsorted_rows_are_sorted_before_the_count():
    """The DAG of a graph with unsorted rows keeps them unsorted (as the
    JAX package's does); the state K9 reads has them sorted."""
    g, _ = _pair("unsorted")
    dag = T.orientation(g)
    assert not dag.has_sorted_neighbors()
    state = TC._tc_device_state(g, "cpu")
    ci, rp = state.col_idx.numpy(), state.row_ptr.numpy()
    for v in range(g.nv):
        row = ci[rp[v]:rp[v + 1]]
        assert np.all(np.diff(row) >= 0)
        assert np.array_equal(row, np.sort(dag.neighbors(v)))


def test_state_cache_is_keyed_by_identity_and_device():
    a, _ = _pair("rmat8")
    b = tgen.rmat(8, 8, seed=4)          # equal arrays, another object
    sa = TC._tc_device_state(a, "cpu")
    assert TC._tc_device_state(a, "cpu") is sa
    assert TC._tc_device_state(b, "cpu") is not sa
    # another device, by its name: the layout is built on the device, so
    # the name is one that runs here
    assert TC._tc_device_state(a, "cpu:0") is not sa


# ---- the plain version against the JAX program -----------------------------

@pytest.mark.parametrize("name", ["uniform", "rmat8", "rmat12", "unsorted"])
def test_pack_padded_and_count_group_equal_jax(name):
    """``_pack_padded`` and ``count_group_plain`` against the JAX
    package's ``_pack_padded`` and ``_count_group`` on the same chunk: a
    seeded draw of DAG edges, some marked invalid, at a narrow and at the
    full width."""
    g, jg = _pair(name)
    dag, jdag = T.orientation(g), JT.orientation(jg)
    sentinel = dag.nv + 1
    nbr, deg = TC._pack_padded(dag, sentinel)
    jnbr, jdeg = JTC._pack_padded(jdag, sentinel)
    assert nbr.dtype == jnbr.dtype and np.array_equal(nbr, jnbr)
    assert np.array_equal(deg, jdeg)
    src, dst = dag.coo()
    rng = np.random.default_rng(7)
    pick = rng.integers(0, dag.ne, 64)
    valid = rng.random(64) < 0.8
    for wa in (8, nbr.shape[1]):
        got = K9.count_group_plain(
            torch.from_numpy(nbr), torch.from_numpy(src[pick]),
            torch.from_numpy(dst[pick]), torch.from_numpy(valid), wa)
        want = JTC._count_group(jnbr, src[pick], dst[pick], valid, wa=wa)
        assert int(got) == int(want)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tc_count_plain_equals_the_serial_count(name):
    g, _ = _pair(name)
    state = TC._tc_device_state(g, "cpu")
    want = TV.triangle_count_serial(T.orientation(g))
    assert int(K9.tc_count_plain(state)) == want
    assert int(K9.tc_count(state)) == want


# ---- the kernel's layout and arithmetic ------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dag_edges_orders_the_edges_by_lane_group(name):
    """Every DAG edge with two non-empty rows is counted once, in the
    group of its shorter row's length; the others are left out."""
    g, _ = _pair(name)
    state = TC._tc_device_state(g, "cpu")
    rp = state.row_ptr.numpy().astype(np.int64)
    deg = np.diff(rp)
    src, dst = state.src.numpy(), state.dst.numpy()
    start = state.group_start
    assert len(start) == GROUPS + 1 and start[0] == 0
    assert list(start) == sorted(start) and start[-1] == len(src)
    dsrc = np.repeat(np.arange(state.nv), deg)
    dcol = state.col_idx.numpy()
    both = (deg[dsrc] > 0) & (deg[dcol] > 0)
    got = sorted(zip(src.tolist(), dst.tolist()))
    assert got == sorted(zip(dsrc[both].tolist(), dcol[both].tolist()))
    widths = (*K9.GROUP_WIDTHS, np.inf)
    for gi in range(GROUPS):
        s = slice(start[gi], start[gi + 1])
        short = np.minimum(deg[src[s]], deg[dst[s]])
        lo = 0 if gi == 0 else widths[gi - 1]
        assert np.all((short > lo) & (short <= widths[gi]))


def _emulate_kernel(state) -> int:
    """tc_count_kernel in numpy: the host entry's block prefix, each
    block's group and edges, each lane's walk of the shorter row with a
    lower bound and a run of equal ids in the longer."""
    rp = state.row_ptr.numpy().astype(np.int64)
    col = state.col_idx.numpy()
    src, dst = state.src.numpy(), state.dst.numpy()
    gs = state.group_start
    block_start, blocks = [], 0
    for g in range(GROUPS):
        block_start.append(blocks)
        per_block = THREADS >> (2 + g)
        blocks += -(-(gs[g + 1] - gs[g]) // per_block)
    block_start.append(blocks)
    seen = np.zeros(len(src), np.int64)
    total = 0
    for blk in range(blocks):
        g = 0
        while g + 1 < GROUPS and blk >= block_start[g + 1]:
            g += 1
        lg = 2 + g
        for t in range(THREADS):
            e = gs[g] + (blk - block_start[g]) * (THREADS >> lg) + (t >> lg)
            if e >= gs[g + 1]:
                continue
            gl = t & ((1 << lg) - 1)
            seen[e] += gl == 0
            u, v = src[e], dst[e]
            a, b = col[rp[u]:rp[u + 1]], col[rp[v]:rp[v + 1]]
            if len(a) > len(b):
                a, b = b, a
            for x in a[gl::1 << lg]:
                k = np.searchsorted(b, x, side="left")
                while k < len(b) and b[k] == x:
                    total += 1
                    k += 1
    assert np.all(seen == 1)
    return total


@pytest.mark.parametrize("name", ["uniform", "rmat8", "edgeless",
                                  "no_triangles", "unsorted"])
def test_kernel_arithmetic_emulated_gives_jax_count(name):
    g, jg = _pair(name)
    assert _emulate_kernel(TC._tc_device_state(g, "cpu")) == \
        JTC.triangle_count(jg)


def test_repeated_ids_count_with_their_multiplicity():
    """A DAG with a repeated neighbour: compare-all counts each pair of
    equal ids, and so do the plain version and the kernel's search."""
    dag = tcsr.CSRGraph(row_ptr=np.array([0, 3, 5, 5]),
                        col_idx=np.array([1, 2, 2, 2, 2], np.int32))
    state = K9.dag_edges(dag.row_ptr, dag.col_idx, device="cpu")
    # edges 0->1 (rows {1,2,2} and {2,2}: 2 * 2) and 0->2, 0->2 (row 2 is
    # empty, left out)
    assert int(K9.tc_count_plain(state)) == 4
    assert _emulate_kernel(state) == 4
    jdag = jcsr.CSRGraph(row_ptr=dag.row_ptr, col_idx=dag.col_idx)
    nbr, _ = JTC._pack_padded(jdag, 4)
    src, dst = jdag.coo()
    assert int(JTC._count_group(nbr, src, dst, np.ones(5, bool), wa=3)) == 4


def test_wrapper_refuses_other_devices_and_types():
    state = TC._tc_device_state(_pair("rmat8")[0], "cpu")
    meta = K9.DagEdges(**{**state.__dict__, "src": state.src.to("meta"),
                          "dst": state.dst.to("meta"),
                          "row_ptr": state.row_ptr.to("meta"),
                          "col_idx": state.col_idx.to("meta")})
    with pytest.raises(ValueError, match="cpu or cuda"):
        K9.tc_count(meta)
    bad = K9.DagEdges(**{**state.__dict__, "src": state.src.long()})
    with pytest.raises(ValueError, match="int32"):
        K9.tc_count(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernel_matches_plain_on_cuda(name):
    """The kernel against its plain version on the card (run at rmat19 by
    chip_smoke.py's analytics phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: tc_count's kernel has no CPU mode")
    g, _ = _pair(name)
    want = TV.triangle_count_serial(T.orientation(g))
    assert int(K9.tc_count(TC._tc_device_state(g, "cuda"))) == want
    assert triangle_count(g, device="cuda") == want
