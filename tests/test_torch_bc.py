"""The port's betweenness centrality (``graphaibench_tpu_torch/analytics/
bc.py``: Brandes in dense level-synchronous sweeps, pull on K8
``neighbor_reduce`` with ELL buckets, push by ``index_add_`` without), held
against the JAX package and the serial oracle ``bc_serial`` on the CPU.

Tolerances: rtol 1e-4 and atol 1e-6, against the JAX package and against
the float64 serial oracle alike: ``sigma`` and ``delta`` are float32 in both
packages, summed in another order by the port's scatters and pull than by
XLA's, and the dependencies divide and multiply path counts that grow with
the depth.
"""

import numpy as np
import pytest
import torch

from graphaibench_tpu.analytics import bc as JBC
from graphaibench_tpu.graph import csr as jcsr
from graphaibench_tpu.graph import generators as jgen
from graphaibench_tpu.graph import transforms as JT
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu_torch.analytics import bc_single_source, betweenness_centrality
from graphaibench_tpu_torch.analytics import verifiers as TV
from graphaibench_tpu_torch.graph import csr as tcsr
from graphaibench_tpu_torch.graph import generators as tgen
from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.ops import device_graph as tdgm

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-6)


def _disconnected(gen, tr, csr):
    """Two rmat pieces side by side and isolated vertices after them."""
    a = gen.rmat(6, 4, seed=5)
    src, dst = a.coo()
    n = a.nv
    return tr.sort_and_clean(tr.symmetrize(csr.from_edges(
        np.r_[src, src + n], np.r_[dst, dst + n], 2 * n + 9)))


GRAPHS = {
    "uniform": lambda gen, tr, csr: gen.uniform_random(150, 500, seed=9),
    "rmat10": lambda gen, tr, csr: gen.rmat(10, 8, seed=6),
    "disconnected": _disconnected,
}
# (graph, source): the last vertices of "disconnected" have no edges
CASES = [("uniform", 0), ("uniform", 17), ("rmat10", 0), ("rmat10", 5),
         ("disconnected", 0), ("disconnected", 70), ("disconnected", 136)]

_CACHE = {}


def _case(name, ell: bool):
    key = (name, ell)
    if key not in _CACHE:
        t = GRAPHS[name](tgen, T, tcsr)
        j = GRAPHS[name](jgen, JT, jcsr)
        assert np.array_equal(t.row_ptr, j.row_ptr)
        assert np.array_equal(t.col_idx, j.col_idx)
        assert T.is_symmetric(t)
        _CACHE[key] = (
            t, tdgm.to_device_graph(t, device="cpu", with_transpose=False,
                                    with_ell=ell),
            jdgm.to_device_graph(j, with_transpose=False, with_ell=ell))
    return _CACHE[key]


@pytest.mark.parametrize("ell", [True, False], ids=["pull", "push"])
@pytest.mark.parametrize("name,source", CASES)
def test_bc_single_source_matches_jax_and_serial(name, source, ell):
    g, dg, jdg = _case(name, ell)
    got = bc_single_source(dg, source)
    assert got.dtype == torch.float32 and tuple(got.shape) == (g.nv,)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(JBC.bc_single_source(jdg, source)),
                               **TOL)
    np.testing.assert_allclose(got, TV.bc_serial(g, [source]), **TOL)
    if g.row_ptr[source + 1] == g.row_ptr[source]:
        assert not got.any()            # a source without edges
    assert got[source] == 0.0


@pytest.mark.parametrize("ell", [True, False], ids=["pull", "push"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_betweenness_centrality_over_three_sources(name, ell):
    g, dg, jdg = _case(name, ell)
    sources = np.random.default_rng(4).choice(g.nv, 3, replace=False)
    got = betweenness_centrality(dg, sources).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JBC.betweenness_centrality(jdg, sources)), **TOL)
    np.testing.assert_allclose(got, TV.bc_serial(g, sources), **TOL)


def test_the_pull_route_sweeps_once_a_level(monkeypatch):
    """One neighbor_reduce a level forward (and one that finds nothing),
    one a level back below the deepest."""
    from graphaibench_tpu_torch.analytics import bc as BC

    g, dg, _ = _case("rmat10", True)
    calls = []
    inner = BC.neighbor_reduce
    monkeypatch.setattr(BC, "neighbor_reduce",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    bc_single_source(dg, 0)
    depth = TV.bfs_serial(g, 0).max()
    assert len(calls) == 2 * depth + 1
