"""The port's k-core decomposition (``graphaibench_tpu_torch/analytics/
kcore.py``: the h-index fixpoint on the kernel K10 ``hindex_sweep`` of
``csrc/kcore_hindex.cu``, wrapper and plain version in ``ops/hindex.py``;
bulk peeling on K8 ``neighbor_reduce`` or an ``index_add_``), the serial
oracle ``k_core_decomposition`` / ``kcore_serial``, held against the JAX
package on the CPU.

Coreness values are integers and must be equal: the port's against the JAX
package's and the serial oracle's, and the h-index fixpoint must take as
many sweeps as the JAX one (both sweep in Jacobi order). On the CPU
``hindex_sweep`` takes its plain version, the JAX package's binary search
over the no-split layout; the kernel's arithmetic (its block prefix and
classes, the short rows' binary search, the histogram searches of a warp's
row and of a hub's block) is emulated in numpy from the constants of its
source, and the kernel itself runs on the card in ``chip_smoke.py``'s
analytics phase and in the test marked ``cuda``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.analytics import kcore as JKC
from graphaibench_tpu.analytics import verifiers as JV
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu_torch.analytics import kcore as KC
from graphaibench_tpu_torch.analytics import k_core, k_core_hindex, k_core_peel
from graphaibench_tpu_torch.analytics import verifiers as TV
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import hindex as K10

torch.set_num_threads(2)

_SOURCE = (_build.CSRC / "kcore_hindex.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", _SOURCE).group(1))
WARP_BINS = int(re.search(r"constexpr int kWarpBins = (\d+);",
                          _SOURCE).group(1))
# a hub block's bins: its warps' together
HUB_BINS = WARP_BINS * THREADS // 32
UNROLL = int(re.search(r"constexpr int kUnroll = (\d+);", _SOURCE).group(1))
assert re.search(r"constexpr int kHubBins = kWarpBins \* kWarps;", _SOURCE)
# (log2 lanes, values a lane) of each class of short rows, from the kernel
SHORT_CLASSES = [tuple(map(int, m)) for m in
                 re.findall(r"short_rows<(\d+), (\d+)>\(", _SOURCE)]


def _isolated(gen, tr, csr):
    """rmat(7, 6) with 20 isolated vertices after its own."""
    g = gen.rmat(7, 6, seed=8)
    src, dst = g.coo()
    return csr.from_edges(src, dst, g.nv + 20)


def _hub(gen, tr, csr):
    """rmat(11, 8) and one more vertex joined to 1,300 of its vertices: a
    row wider than the row kernel's widest class."""
    g = gen.rmat(11, 8, seed=3)
    src, dst = g.coo()
    hub = np.full(1300, g.nv)
    leaves = np.arange(1300)
    return csr.from_edges(np.r_[src, hub, leaves], np.r_[dst, leaves, hub],
                          g.nv + 1)


def _wide_hub(gen, tr, csr):
    """rmat(9, 8) and one more vertex joined to 300 of its vertices and to
    2,600 leaves of its own: a row wider than a hub block's histogram."""
    g = gen.rmat(9, 8, seed=5)
    src, dst = g.coo()
    hub = g.nv
    nbrs = np.r_[np.arange(300), hub + 1 + np.arange(2600)]
    return csr.from_edges(np.r_[src, np.full(len(nbrs), hub), nbrs],
                          np.r_[dst, nbrs, np.full(len(nbrs), hub)],
                          g.nv + 2601)


GRAPHS = {
    "uniform": lambda gen, tr, csr: gen.uniform_random(150, 500, seed=9),
    "rmat11": lambda gen, tr, csr: gen.rmat(11, 8, seed=3),   # rows > 64
    "hub": _hub,
    "wide_hub": _wide_hub,
    "isolated": _isolated,
    "edgeless": lambda gen, tr, csr: csr.from_edges([], [], 7),
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


class _Counted:
    """Counts the calls of a module's ``_hindex_sweep`` while active."""

    def __init__(self, module, monkeypatch):
        self.n = 0
        inner = module._hindex_sweep

        def counted(*args):
            self.n += 1
            return inner(*args)

        monkeypatch.setattr(module, "_hindex_sweep", counted)


# ---- the host oracle and layout --------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k_core_decomposition_and_kcore_serial_equal_jax(name):
    g, jg = _pair(name)
    a, b = T.k_core_decomposition(g), JT.k_core_decomposition(jg)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = TV.kcore_serial(g), JV.kcore_serial(jg)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_hindex_layout_equals_jax(name):
    g, jg = _pair(name)
    ours, theirs = KC._hindex_layout(g), JKC._hindex_layout(jg)
    assert len(ours) == len(theirs)
    for (w, rows, nbr, eid), b in zip(ours, theirs):
        assert w == b.width
        for a, c in ((rows, b.row_ids), (nbr, b.nbr), (eid, b.edge_id)):
            assert np.array_equal(a, np.asarray(c).reshape(-1))


# ---- the plain version against the JAX program -----------------------------

@pytest.mark.parametrize("w", [4, 8, 16, 64, 256, 1024, 2048])
def test_row_hindex_equals_jax(w):
    """Random blocks clamped to w, as the sweep makes them: values from 0
    up to past w, some rows all zero."""
    rng = np.random.default_rng(w)
    vals = np.minimum(rng.integers(0, 2 * w + 3, (37, w)), w).astype(np.int32)
    vals[::7] = 0
    vals[3, : w // 2] = w
    got = KC._row_hindex(torch.from_numpy(vals), w)
    want = JKC._row_hindex(jnp.asarray(vals), w, jnp.int32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the h-index by definition
    ref = [max([t for t in range(w + 1) if (row >= t).sum() >= t])
           for row in vals]
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", ["uniform", "rmat11", "hub", "isolated"])
def test_one_sweep_equals_jax(name):
    """One sweep from the degrees and one from a seeded random core: new
    values and the changed count equal to the JAX package's."""
    g, jg = _pair(name)
    layout = KC.hindex_state(g, device="cpu")
    jbuckets = JKC._hindex_layout(jg)
    rng = np.random.default_rng(2)
    for core in (g.degrees().astype(np.int32),
                 rng.integers(0, 40, g.nv).astype(np.int32)):
        new, changed = KC._hindex_sweep(torch.from_numpy(core), layout)
        jnew, jchanged = JKC._hindex_sweep(jnp.asarray(core), jbuckets, jg.ne)
        assert np.array_equal(new.numpy(), np.asarray(jnew))
        assert int(changed) == int(jchanged)


# ---- the solvers -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k_core_hindex_matches_jax_sweep_for_sweep(name, monkeypatch):
    g, jg = _pair(name)
    ours = _Counted(KC, monkeypatch)
    theirs = _Counted(JKC, monkeypatch)
    core = k_core_hindex(g, device="cpu")
    want = np.asarray(JKC.k_core_hindex(jg))
    assert core.dtype == torch.int32
    assert np.array_equal(core.numpy(), want)
    assert np.array_equal(core.numpy(), TV.kcore_serial(g))
    assert ours.n == theirs.n


@pytest.mark.parametrize("ell", [True, False], ids=["pull", "push"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k_core_peel_matches_jax_and_serial(name, ell):
    g, jg = _pair(name)
    dg = tdgm.to_device_graph(g, device="cpu", with_transpose=False,
                              with_ell=ell)
    jdg = jdgm.to_device_graph(jg, with_transpose=False, with_ell=ell)
    core = k_core_peel(dg).numpy()
    assert np.array_equal(core, TV.kcore_serial(g))
    if g.nv:
        assert np.array_equal(core, np.asarray(JKC.k_core_peel(jdg)))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k_core_takes_each_route(name):
    g, jg = _pair(name)
    want = TV.kcore_serial(g)
    dg = tdgm.to_device_graph(g, device="cpu", with_transpose=False)
    for got in (k_core(None, host=g, device="cpu"), k_core(dg, host=g),
                k_core(dg)):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.asarray(JKC.k_core(None, host=jg)), want)


def test_k_core_hindex_takes_a_caller_layout_and_start():
    g, _ = _pair("rmat11")
    layout = KC.hindex_state(g, device="cpu")
    want = TV.kcore_serial(g)
    assert np.array_equal(k_core_hindex(g, layout=layout).numpy(), want)
    # started above the degrees, the fixpoint still comes down to them
    deg = torch.from_numpy(g.degrees().astype(np.int32))
    assert np.array_equal(k_core_hindex(g, deg.clone(), layout).numpy(), want)


# ---- the kernel's layout and arithmetic ------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_layout_orders_every_vertex_by_class(name):
    """Every vertex once: the hubs first, widest first, then each class's
    rows in vertex order, every row within its class's bounds."""
    g, _ = _pair(name)
    layout = KC.hindex_state(g, device="cpu")
    rows = layout.rows.numpy()
    assert sorted(rows.tolist()) == list(range(g.nv))
    deg = g.degrees()
    start = layout.class_start
    assert len(start) == len(K10.CLASS_WIDTHS) + 2
    assert start[0] == 0 and start[-1] == g.nv
    assert list(start) == sorted(start)
    hubs = rows[:start[1]]
    assert np.all(deg[hubs] > K10.CLASS_WIDTHS[-1])
    assert np.all(np.diff(deg[hubs]) <= 0)
    assert layout.hub_width == (deg[hubs].max() if len(hubs) else 0)
    bounds = (-1, *K10.CLASS_WIDTHS)
    for c in range(len(K10.CLASS_WIDTHS)):
        r = rows[start[c + 1]:start[c + 2]]
        assert np.all((deg[r] > bounds[c]) & (deg[r] <= bounds[c + 1]))
        assert np.all(np.diff(r) > 0)
    # each class of short rows holds its widest row in its lanes' values;
    # the warp a row takes the rest up to the hubs
    assert len(SHORT_CLASSES) == len(K10.CLASS_WIDTHS) - 1
    for (lg, k), width in zip(SHORT_CLASSES, K10.CLASS_WIDTHS):
        assert (1 << lg) * k == width


_EARLY = {"passes": 0}       # passes that stopped with hi


def _histogram_search(vals: np.ndarray, c: int, bins: int,
                      threads: int) -> int:
    """warp_hindex (32 threads) and block_hindex: max t <= c with
    #{min(x, c) >= t} >= t by histograms of ``bins`` bins over [lo, hi],
    each scanned from the top bin down; the first pass gives each value
    below lo + bins - 1 a bin and the rest the top bin, a later pass splits
    [lo, hi] evenly, and the search goes on inside the bin found until it
    is one value wide. A pass, in rounds of UNROLL values a thread, stops
    with hi once as many values as hi have reached it."""
    lo, hi = 0, c
    first = True
    while lo < hi:
        span = hi - lo + 1
        if first or span <= bins:
            w, nb = 1, min(span, bins)
        else:
            w = -(-span // bins)
            nb = -(-span // w)
        first = False
        y = np.minimum(vals, hi)
        reached = np.cumsum(y == hi)
        ends = np.minimum(np.arange(UNROLL * threads, len(y) + UNROLL *
                                    threads, UNROLL * threads), len(y))
        if len(y) and np.any(reached[ends - 1] >= hi):
            _EARLY["passes"] += 1
            return hi
        y = y[y >= lo]
        hist = np.bincount(np.minimum((y - lo) // w, nb - 1), minlength=nb)
        assert len(hist) == nb
        suffix = np.cumsum(hist[::-1])[::-1]       # S at each bin's edge
        hit = np.nonzero(suffix >= lo + np.arange(nb) * w)[0]
        assert hit[0] == 0                         # S(lo) >= lo
        found = hit[-1]                            # the first from the top
        lo += found * w
        if found < nb - 1:
            hi = lo + w - 1
    return lo


def _emulate_sweep(layout, core: np.ndarray, hub_bins: int = HUB_BINS,
                   warp_bins: int = WARP_BINS):
    """The kernel in numpy, block by block: the host entry's block prefix,
    a hub's block with its histogram search, a warp's row with its own,
    each short row's group with a binary search over its lanes' values (0
    past the row), its first step at hi, until lo meets hi; a row without
    neighbours keeps its value."""
    rp = layout.row_ptr.numpy().astype(np.int64)
    col = layout.col_idx.numpy()
    rows = layout.rows.numpy()
    start = layout.class_start
    lanes = [lg for lg, _ in SHORT_CLASSES] + [5]   # the warp a row
    block_start, blocks = [], start[1] - start[0]
    for c in range(len(lanes)):
        block_start.append(blocks)
        per_block = THREADS >> lanes[c]
        blocks += -(-(start[c + 2] - start[c + 1]) // per_block)
    block_start.append(blocks)
    new = np.full_like(core, -1)
    changed = 0
    for blk in range(blocks):
        if blk < start[1]:
            first = [rows[blk]]
            c = None
        else:
            c = 0
            while blk >= block_start[c + 1]:
                c += 1
            per_block = THREADS >> lanes[c]
            r0 = start[c + 1] + (blk - block_start[c]) * per_block
            first = rows[r0:min(r0 + per_block, start[c + 2])]
        for v in first:
            d = rp[v + 1] - rp[v]
            vals = core[col[rp[v]:rp[v + 1]]].astype(np.int64)
            top = min(d, core[v])
            if c is None:
                nw = _histogram_search(vals, top, hub_bins, THREADS)
            elif c == len(SHORT_CLASSES):
                nw = _histogram_search(vals, top, warp_bins, 32)
            else:
                lg, k = SHORT_CLASSES[c]
                padded = np.zeros((1 << lg) * k, np.int64)
                padded[:d] = vals
                lo, hi = 0, top
                mid = hi                # the first step asks for hi
                while lo < hi:
                    if (padded >= mid).sum() >= mid:
                        lo = mid
                    else:
                        hi = mid - 1
                    mid = (lo + hi + 1) >> 1
                nw = core[v] if d == 0 else lo
            assert new[v] == -1
            new[v] = nw
            changed += nw != core[v]
    assert np.all(new >= 0)
    return new, changed


@pytest.mark.parametrize("name", ["uniform", "hub", "isolated", "wide_hub"])
def test_kernel_arithmetic_emulated_equals_plain(name):
    g, _ = _pair(name)
    layout = KC.hindex_state(g, device="cpu")
    rng = np.random.default_rng(5)
    early = _EARLY["passes"]
    for core in (g.degrees().astype(np.int32),
                 rng.integers(0, 3000, g.nv).astype(np.int32)):
        want, want_changed = K10.hindex_sweep_plain(layout,
                                                    torch.from_numpy(core))
        # the kernel's bins, then bins so few that every histogram search
        # narrows over several passes
        for hub_bins, warp_bins in ((HUB_BINS, WARP_BINS), (7, 5)):
            new, changed = _emulate_sweep(layout, core, hub_bins, warp_bins)
            assert np.array_equal(new, want.numpy())
            assert changed == int(want_changed)
    # the random core stops some passes early
    assert _EARLY["passes"] > early or name in ("uniform", "isolated")


def test_hub_graph_has_every_class():
    """The graph the emulation runs on exercises every path of K10."""
    g, _ = _pair("hub")
    layout = KC.hindex_state(g, device="cpu")
    assert all(b > a for a, b in zip(layout.class_start, layout.class_start[1:]))


def test_wide_hub_is_wider_than_the_hub_bins():
    """The wide hub's first pass, from the degrees, has a top bin wider
    than one value (c + 1 > the block's bins); its answer lies below it,
    found in that one pass."""
    g, _ = _pair("wide_hub")
    layout = KC.hindex_state(g, device="cpu")
    assert layout.class_start[1] == 1
    assert layout.hub_width == 2900 and layout.hub_width + 1 > HUB_BINS
    hub = int(layout.rows[0])
    deg = g.degrees().astype(np.int32)
    vals = deg[g.col_idx[g.row_ptr[hub]:g.row_ptr[hub + 1]]]
    want = max(t for t in range(len(vals) + 1) if (vals >= t).sum() >= t)
    assert _histogram_search(vals, int(deg[hub]), HUB_BINS, THREADS) == want


def test_wrapper_refuses_a_bad_core():
    g, _ = _pair("uniform")
    layout = KC.hindex_state(g, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        K10.hindex_sweep(layout, torch.zeros(g.nv, dtype=torch.int64))
    with pytest.raises(ValueError, match="without the plain"):
        K10.hindex_sweep(KC.hindex_state(g, device="cpu", with_plain=False),
                         torch.zeros(g.nv, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_kernel_matches_plain_on_cuda(name):
    """The kernel against its plain version on the card, from the degrees
    and from a seeded core (run at rmat19 by chip_smoke.py's analytics
    phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: hindex_sweep's kernel has no CPU "
                    "mode")
    g, _ = _pair(name)
    layout = KC.hindex_state(g, device="cuda", with_plain=True)
    rng = np.random.default_rng(5)
    for core in (g.degrees().astype(np.int32),
                 rng.integers(0, 3000, g.nv).astype(np.int32)):
        core = torch.from_numpy(core).cuda()
        new, changed = K10.hindex_sweep(layout, core)
        want, want_changed = K10.hindex_sweep_plain(layout, core)
        assert torch.equal(new, want) and int(changed) == int(want_changed)
    assert np.array_equal(k_core_hindex(g, device="cuda").cpu().numpy(),
                          TV.kcore_serial(g))
