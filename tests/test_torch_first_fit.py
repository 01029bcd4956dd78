"""Greedy coloring of the port (``analytics/coloring.py``) and its first-fit
step, the kernel K14 (``csrc/coloring.cu``, ``ops/first_fit.py``), held
against the JAX package on the CPU.

``first_fit_plain`` is held to JAX's first-fit expression
(``graphaibench_tpu/analytics/coloring.py:23-32``, a closure of ``color``,
written out here as it stands there) on random colours, active rows and
``max_colors``, self-loops included, and ``color`` to JAX's ``color``; both
exact. The kernel's source is compiled by g++ against the emulation header
of ``test_torch_device_decode.py`` (a block's threads as host threads,
``__syncthreads`` and ``__syncwarp`` barriers) plus ``__ballot_sync``,
``__ffs`` and a shared-memory ``atomicOr``, and held to the plain version
exactly; the ``cuda`` cases run the kernel itself on the card.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.analytics import coloring as JC
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu_torch.analytics import verifiers as TV
from graphaibench_tpu_torch.analytics.coloring import color
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import first_fit as FF
from graphaibench_tpu_torch.ops.device_graph import to_device_graph
from test_torch_device_decode import EMULATION, build_emulated

torch.set_num_threads(2)

# what K14's emulation adds to the header: a warp's vote, find-first-set and
# an atomic OR (under the header's mutex)
EMULATION_K14 = EMULATION + r"""
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned t = threadIdx.x;
  shuffled[t] = pred != 0;
  __syncwarp();
  unsigned r = 0;
  for (unsigned i = 0; i < 32; ++i)
    r |= static_cast<unsigned>(shuffled[(t & ~31u) + i]) << i;
  __syncwarp();
  return r;
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> g(atomics);
  const unsigned o = *p;
  *p = o | v;
  return o;
}
inline int min(int a, int b) { return a < b ? a : b; }
"""


def _pair(build):
    """The graph ``build(gen, transforms, csr)`` in each package, equal."""
    jg, tg = build(jgen, JT, jcsr), build(tgen, T, tcsr)
    assert np.array_equal(jg.row_ptr, tg.row_ptr)
    assert np.array_equal(jg.col_idx, tg.col_idx)
    return jg, tg


def _with_selfloops(gen, tr, csr):
    g = gen.rmat(9, 6, seed=4)
    src, dst = g.coo()
    loops = np.arange(0, g.nv, 3)
    return tr.sort_and_clean(csr.from_edges(np.r_[src, loops],
                                            np.r_[dst, loops], g.nv))


def _disconnected(gen, tr, csr):
    a = gen.rmat(6, 4, seed=5)
    src, dst = a.coo()
    n = a.nv
    return tr.sort_and_clean(tr.symmetrize(csr.from_edges(
        np.r_[src, src + n], np.r_[dst, dst + n], 2 * n + 9)))


GRAPHS = {
    "rmat10": lambda gen, tr, csr: gen.rmat(10, 8, seed=0),
    "directed": lambda gen, tr, csr: gen.rmat(8, 6, seed=2, undirected=False),
    "selfloops": _with_selfloops,
    "disconnected": _disconnected,
    "edgeless": lambda gen, tr, csr: csr.from_edges(
        np.zeros(0, np.int64), np.zeros(0, np.int64), 17),
}


def jax_first_fit(dg, colors, active, max_colors):
    """JAX's first-fit step, as written in ``color``
    (graphaibench_tpu/analytics/coloring.py:23-32)."""
    nv = dg.nv
    src, dst = dg.edge_src, dg.col_idx
    forb = (jnp.zeros((nv, max_colors), bool)
            .at[src, colors[dst]]
            .max(src != dst))
    smallest = jnp.argmax(~forb, axis=1)
    return jnp.where(active, smallest, colors)


def _inputs(nv: int, max_colors: int, seed: int):
    rng = np.random.default_rng(seed)
    colors = rng.integers(0, max_colors, nv).astype(np.int32)
    active = rng.random(nv) < 0.6
    return colors, active


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("max_colors", [1, 2, 3, 8, None])
def test_first_fit_plain_equals_jax(name, max_colors):
    """Random colours and active rows; ``max_colors`` 1-3 leave most rows
    with every colour taken (JAX's argmax of all-False: 0), None the
    default of ``color`` (the largest degree + 2)."""
    jg, tg = _pair(GRAPHS[name])
    jdg = jdgm.to_device_graph(jg, with_transpose=False, with_ell=False)
    tdg = to_device_graph(tg, device="cpu", with_transpose=False,
                          with_ell=False)
    mc = max_colors or int(tg.degrees().max(initial=0)) + 2
    for seed in range(3):
        colors, active = _inputs(tg.nv, mc, seed)
        want = np.asarray(jax_first_fit(jdg, jnp.asarray(colors),
                                        jnp.asarray(active), mc))
        got = FF.first_fit(tdg, torch.from_numpy(colors),
                           torch.from_numpy(active), mc)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (name, mc, seed)


def test_first_fit_all_taken_gives_zero():
    """A vertex whose three neighbours hold colours 0, 1 and 2 takes 3, and
    0 where max_colors is 3 (every colour taken); a self-loop forbids
    nothing."""
    g = tcsr.from_edges(np.array([0, 0, 0, 0]), np.array([0, 1, 2, 3]), 4)
    dg = to_device_graph(g, device="cpu", with_transpose=False,
                         with_ell=False)
    colors = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    active = torch.tensor([True, False, False, False])
    assert FF.first_fit(dg, colors, active, 4).tolist() == [3, 0, 1, 2]
    assert FF.first_fit(dg, colors, active, 3).tolist() == [0, 0, 1, 2]
    colors[1:] = torch.tensor([3, 5, 4], dtype=torch.int32)
    assert FF.first_fit(dg, colors, active, 8).tolist() == [0, 3, 5, 4]


def test_first_fit_refuses_bad_operands():
    g = tgen.rmat(5, 4, seed=0)
    dg = to_device_graph(g, device="cpu", with_transpose=False,
                         with_ell=False)
    c = torch.zeros(g.nv, dtype=torch.int32)
    a = torch.ones(g.nv, dtype=torch.bool)
    with pytest.raises(ValueError, match="int32"):
        FF.first_fit(dg, c.long(), a, 4)
    with pytest.raises(ValueError, match="bool"):
        FF.first_fit(dg, c, a.to(torch.uint8), 4)
    with pytest.raises(ValueError, match="max_colors"):
        FF.first_fit(dg, c, a, 0)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("max_colors", [None, 3])
def test_color_equals_jax(name, max_colors):
    """The whole solve, colours exact; valid where max_colors leaves room
    and the graph is symmetric (on a directed one a row sees only its
    out-neighbours, in both packages)."""
    jg, tg = _pair(GRAPHS[name])
    jdg = jdgm.to_device_graph(jg, with_transpose=False, with_ell=False)
    tdg = to_device_graph(tg, device="cpu", with_transpose=False,
                          with_ell=False)
    want = np.asarray(JC.color(jdg, max_colors=max_colors))
    got = color(tdg, max_colors=max_colors)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if max_colors is None and name != "directed":
        assert TV.coloring_valid(tg, got.numpy())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_color_reports_its_rounds(name, monkeypatch):
    """``return_rounds`` gives the colours of a plain call and the number of
    first-fit steps the solve ran, one a round (a single round on the
    edgeless graph, whose colours 0 conflict with nothing)."""
    import graphaibench_tpu_torch.analytics.coloring as COL

    _, tg = _pair(GRAPHS[name])
    tdg = to_device_graph(tg, device="cpu", with_transpose=False,
                          with_ell=False)
    calls = []

    def counted(*args):
        calls.append(1)
        return FF.first_fit(*args)

    monkeypatch.setattr(COL, "first_fit", counted)
    colors, rounds = COL.color(tdg, return_rounds=True)
    assert rounds == len(calls) >= 1
    assert np.array_equal(colors.numpy(), COL.color(tdg).numpy())
    if name == "edgeless":
        assert rounds == 1


# ---- the kernel's source under g++ ----------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/coloring.cu`` built by g++ for the host: the launch run block
    after block, a block's threads as host threads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("k14"), "coloring.cu", 1,
                          EMULATION_K14)


@pytest.fixture(scope="module")
def emulated_small_hubs(tmp_path_factory):
    """The same with kHubDegree 8: every row of more than 8 neighbours a
    block."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    return build_emulated(tmp_path_factory.mktemp("k14_hubs"), "coloring.cu",
                          1, EMULATION_K14, {"kHubDegree": 8})


def _emulated_first_fit(lib, g, colors, active, max_colors, hub_degree):
    rp = torch.from_numpy(np.asarray(g.row_ptr, np.int32))
    col = torch.from_numpy(np.asarray(g.col_idx, np.int32))
    hubs = torch.from_numpy(np.flatnonzero(g.degrees() > hub_degree)
                            .astype(np.int32))
    act = torch.from_numpy(active.astype(np.uint8))
    c = torch.from_numpy(colors)
    out = torch.full((g.nv,), -7, dtype=torch.int32)
    assert lib.gab_first_fit(rp.data_ptr(), col.data_ptr(), c.data_ptr(),
                             act.data_ptr(), hubs.data_ptr(), hubs.numel(),
                             g.nv, max_colors, out.data_ptr(), 0, None) == 0
    return out


def _plain(g, colors, active, max_colors):
    dg = to_device_graph(g, device="cpu", with_transpose=False,
                         with_ell=False)
    return FF.first_fit_plain(dg, torch.from_numpy(colors),
                              torch.from_numpy(active), max_colors)


def _star_of_colours(leaves: int, extra_rows: int):
    """A star whose centre 0 sees colours 0..leaves-1 on its leaves, which
    also form a path; then ``extra_rows`` isolated rows."""
    hub = np.zeros(leaves, np.int64)
    leaf = np.arange(1, leaves + 1)
    src = np.r_[hub, leaf[:-1]]
    dst = np.r_[leaf, leaf[1:]]
    g = T.sort_and_clean(T.symmetrize(tcsr.from_edges(
        src, dst, leaves + 1 + extra_rows)))
    colors = np.zeros(g.nv, np.int32)
    colors[1:leaves + 1] = np.arange(leaves, dtype=np.int32)
    return g, colors


@pytest.mark.parametrize("name", ["rmat10", "selfloops", "disconnected",
                                  "edgeless"])
@pytest.mark.parametrize("max_colors", [3, None])
def test_k14_source_equals_plain(emulated, name, max_colors):
    _, g = _pair(GRAPHS[name])
    mc = max_colors or int(g.degrees().max(initial=0)) + 2
    colors, active = _inputs(g.nv, mc, 11)
    got = _emulated_first_fit(emulated, g, colors, active, mc,
                              FF.HUB_DEGREE)
    assert torch.equal(got, _plain(g, colors, active, mc))


def test_k14_source_second_windows(emulated):
    """A row of 1,024 neighbours holding colours 0..1023 finds 1024 in the
    second 1,024-colour window of its warp; a hub of 8,300 leaves holding
    0..8299 finds 8300 in its block's second 8,192-colour window; a
    max_colors inside the first window gives 0."""
    for leaves, mc in ((1024, 1100), (1024, 1000), (8300, 9000),
                       (8300, 8300)):
        g, colors = _star_of_colours(leaves, 5)
        active = np.zeros(g.nv, bool)
        active[[0, 1, leaves, g.nv - 1]] = True
        got = _emulated_first_fit(emulated, g, colors, active, mc,
                                  FF.HUB_DEGREE)
        want = _plain(g, colors, active, mc)
        assert torch.equal(got, want)
        assert int(got[0]) == (leaves if mc > leaves else 0)


@pytest.mark.parametrize("name", ["rmat10", "selfloops", "disconnected"])
def test_k14_source_hub_blocks_equal_plain(emulated_small_hubs, name):
    """Every row of more than 8 neighbours a block of its own."""
    _, g = _pair(GRAPHS[name])
    mc = int(g.degrees().max(initial=0)) + 2
    for seed, m in ((0, mc), (1, 4)):
        colors, active = _inputs(g.nv, m, seed)
        got = _emulated_first_fit(emulated_small_hubs, g, colors, active, m,
                                  8)
        assert torch.equal(got, _plain(g, colors, active, m))


def test_k14_hub_degree_matches_source():
    src = (FF._build.CSRC / "coloring.cu").read_text()
    assert f"constexpr int kHubDegree = {FF.HUB_DEGREE};" in src


# ---- the kernel on the card -----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat10", "selfloops", "disconnected"])
def test_k14_equals_plain_on_cuda(name):
    """The kernel against its plain version on the card (run at rmat19 by
    chip_smoke.py's p15a phase)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K14 first_fit has no CPU mode")
    _, g = _pair(GRAPHS[name])
    mc = int(g.degrees().max(initial=0)) + 2
    dgc = to_device_graph(g, device="cuda", with_transpose=False,
                          with_ell=False)
    for m in (mc, 3):
        colors, active = _inputs(g.nv, m, 5)
        got = FF.first_fit(dgc, torch.from_numpy(colors).cuda(),
                           torch.from_numpy(active).cuda(), m).cpu()
        assert torch.equal(got, _plain(g, colors, active, m))


@pytest.mark.cuda
def test_k14_second_windows_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K14 first_fit has no CPU mode")
    for leaves, mc in ((1024, 1100), (8300, 9000), (8300, 8300)):
        g, colors = _star_of_colours(leaves, 5)
        active = np.ones(g.nv, bool)
        dgc = to_device_graph(g, device="cuda", with_transpose=False,
                              with_ell=False)
        got = FF.first_fit(dgc, torch.from_numpy(colors).cuda(),
                           torch.from_numpy(active).cuda(), mc).cpu()
        assert torch.equal(got, _plain(g, colors, active, mc))
