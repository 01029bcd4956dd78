"""The port's segment ops and per-edge ops against the JAX package's at
rmat10 (which has edgeless rows) and on the graph with degrees 64, 65,
199: row reductions, ``segment_softmax`` and its gradient, its explicit
adjoint, ``sddmm_add`` and its adjoint, ``sddmm_dot`` chunked and not.
Tolerance rtol = atol = 1e-5 (float32 sums in another order); the row max
is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.transforms import add_selfloop
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.ops import segment as jseg
from graphaibench_tpu.ops.spmm import sddmm_add as jax_sddmm_add
from graphaibench_tpu.ops.spmm import sddmm_dot as jax_sddmm_dot
from graphaibench_tpu.ops import fused_gat as jfg
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import ell_edge as tee
from graphaibench_tpu_torch.ops import segment as tseg
from graphaibench_tpu_torch.ops import spmm as tspmm
from test_torch_device_graph import hubs_graph

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

GRAPHS = {
    "rmat10": lambda: rmat(10, 8, seed=0),                # edgeless rows
    "rmat10_selfloops": lambda: add_selfloop(rmat(10, 8, seed=0)),
    "hubs": hubs_graph,
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    g = GRAPHS[request.param]()
    rng = np.random.default_rng(7)
    arrs = dict(e=rng.standard_normal(g.ne).astype(np.float32),
                e2=rng.standard_normal(g.ne).astype(np.float32),
                a=rng.standard_normal(g.nv).astype(np.float32),
                b=rng.standard_normal(g.nv).astype(np.float32),
                x=rng.standard_normal((g.nv, 12)).astype(np.float32),
                y=rng.standard_normal((g.nv, 12)).astype(np.float32))
    return (g, jdgm.to_device_graph(g, seg_ell=False),
            tdgm.to_device_graph(g, device="cpu"), arrs)


@pytest.mark.parametrize("kind", ["sum", "max"])
def test_row_reduce_matches_jax(case, kind):
    g, jdg, tdg, arrs = case
    ours = tseg._row_reduce_ell(tdg, torch.from_numpy(arrs["e"]), kind).numpy()
    theirs = np.asarray(jseg._row_reduce_ell(jdg, jnp.asarray(arrs["e"]), kind))
    if kind == "max":
        np.testing.assert_array_equal(ours, theirs)
        assert np.isneginf(ours[g.degrees() == 0]).all()
    else:
        np.testing.assert_allclose(ours, theirs, **TOL)
        np.testing.assert_allclose(
            tseg.segment_sum_edges(tdg, torch.from_numpy(arrs["e"])).numpy(),
            np.asarray(jseg.segment_sum_edges(jdg, jnp.asarray(arrs["e"]))),
            **TOL)


def test_segment_softmax_and_grad_match_jax(case):
    _, jdg, tdg, arrs = case
    je, jct = jnp.asarray(arrs["e"]), jnp.asarray(arrs["e2"])
    # jitted: one compile instead of one per eager op and shape
    jy = jax.jit(lambda s: jseg.segment_softmax(jdg, s))(je)
    jgrad = jax.jit(jax.grad(
        lambda s: (jseg.segment_softmax(jdg, s) * jct).sum()))(je)
    te = torch.from_numpy(arrs["e"]).requires_grad_(True)
    ty = tseg.segment_softmax(tdg, te)
    (ty * torch.from_numpy(arrs["e2"])).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jgrad), **TOL)
    # every non-empty row sums to one
    sums = tseg.segment_sum_edges(tdg, ty.detach()).numpy()
    deg = tdg.deg.numpy()
    np.testing.assert_allclose(sums[deg > 0], 1.0, rtol=1e-5)
    # the explicit adjoint equals autograd's and the JAX package's
    vjp = tseg.segment_softmax_vjp(tdg, ty.detach(),
                                   torch.from_numpy(arrs["e2"]))
    np.testing.assert_allclose(vjp.numpy(), te.grad.numpy(), **TOL)
    np.testing.assert_allclose(
        vjp.numpy(), np.asarray(jseg.segment_softmax_vjp(jdg, jy, jct)), **TOL)


def test_sddmm_add_and_adjoint_match_jax(case):
    g, jdg, tdg, arrs = case
    ja, jb, jct = (jnp.asarray(arrs[k]) for k in ("a", "b", "e"))
    jout = jax_sddmm_add(jdg, ja, jb)
    jda, jdb = jax.grad(lambda a, b: (jax_sddmm_add(jdg, a, b) * jct).sum(),
                        argnums=(0, 1))(ja, jb)
    ta = torch.from_numpy(arrs["a"]).requires_grad_(True)
    tb = torch.from_numpy(arrs["b"]).requires_grad_(True)
    out = tspmm.sddmm_add(tdg, ta, tb)
    (out * torch.from_numpy(arrs["e"])).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **TOL)
    # the destination side by its definition: sums by col_idx
    src, dst = g.coo()
    want = np.zeros(g.nv, np.float64)
    np.add.at(want, dst, arrs["e"].astype(np.float64))
    np.testing.assert_allclose(tb.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("chunk_elems", [1 << 28, 12 * 1000, 12])
def test_sddmm_dot_chunked_matches_jax(case, chunk_elems):
    _, jdg, tdg, arrs = case
    want = np.asarray(jax_sddmm_dot(jdg, jnp.asarray(arrs["x"]),
                                      jnp.asarray(arrs["y"])))
    if chunk_elems == 12 and tdg.ne > 5000:
        chunk_elems = 12 * 97       # an edge at a time is slow at rmat10
    ours = tspmm.sddmm_dot(tdg, torch.from_numpy(arrs["x"]),
                           torch.from_numpy(arrs["y"]),
                           chunk_elems=chunk_elems)
    assert ours.shape == (tdg.ne,)
    np.testing.assert_allclose(ours.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", ["sum", "max", "sumexp"])
def test_ell_row_reduce_plain_matches_jax(case, kind):
    """The plain version of the kernel ``ell_row_reduce`` (a sweep of the
    ELL buckets through the slots' edge ids) against the JAX package's
    ``_row_reduce_ell`` and ``_row_denom_ell``, edgeless rows included;
    the max is exact."""
    g, jdg, tdg, arrs = case
    e = torch.from_numpy(arrs["e"])
    if kind == "sumexp":
        jm_ = jseg._row_reduce_ell(jdg, jnp.asarray(arrs["e"]), "max")
        jm_ = jnp.where(jnp.isfinite(jm_), jm_, 0.0)
        want = jfg._row_denom_ell(jdg, jnp.asarray(arrs["e"]), jm_)
        got = tee.ell_row_reduce(tdg, e, kind, torch.tensor(np.asarray(jm_)))
    else:
        want = jseg._row_reduce_ell(jdg, jnp.asarray(arrs["e"]), kind)
        got = tee.ell_row_reduce(tdg, e, kind)
    empty = g.degrees() == 0
    assert (got.numpy()[empty] == (-np.inf if kind == "max" else 0.0)).all()
    if kind == "max":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same numbers as the reduction over edge_src
    if kind != "sumexp":
        np.testing.assert_allclose(got.numpy(),
                                   tseg._row_reduce_ell(tdg, e, kind).numpy(),
                                   **TOL)


def test_sddmm_dot_ell_plain_matches_jax(case):
    """The plain version of the kernel ``sddmm_dot_ell`` writes every
    edge's <a[src], b[dst]> through the slots' edge ids."""
    _, jdg, tdg, arrs = case
    want = jax_sddmm_dot(jdg, jnp.asarray(arrs["x"]), jnp.asarray(arrs["y"]))
    got = tee.sddmm_dot_ell(tdg, torch.from_numpy(arrs["x"]),
                            torch.from_numpy(arrs["y"]))
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_row_sum_kernel_route_has_the_gather_adjoint(case, monkeypatch):
    """On a CUDA graph ``_row_reduce_ell`` goes through an autograd
    Function around the kernel; its adjoint (a gather by edge source)
    equals autograd's through ``index_add_``. Driven on the CPU with the
    plain version in the kernel's place."""
    _, _, tdg, arrs = case
    e = torch.from_numpy(arrs["e"]).requires_grad_(True)
    ct = torch.from_numpy(arrs["a"])
    (tseg._row_reduce_ell(tdg, e, "sum") * ct).sum().backward()
    want = e.grad.clone()
    e.grad = None
    (tseg._RowSumEll.apply(tdg, e) * ct).sum().backward()
    np.testing.assert_array_equal(e.grad.numpy(), want.numpy())
