"""The port's SpMM against the JAX package's: the plain version of kernel
K1 against the Pallas kernel (interpret mode) and the XLA ELL path, and
``spmm``'s forward and gradients against ``jax.grad`` of JAX ``spmm``.
Tolerances: float32 sums taken in another order, rtol = atol = 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphaibench_tpu.graph.generators import rmat
from graphaibench_tpu.graph.transforms import add_selfloop
from graphaibench_tpu.ops import device_graph as jdgm
from graphaibench_tpu.ops.spmm import spmm as jax_spmm
from graphaibench_tpu.ops.spmm import spmm_ell as jax_spmm_ell
from graphaibench_tpu.ops.pallas_spmm import spmm_ell_pallas
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import device_graph as tdgm
from graphaibench_tpu_torch.ops import ell_spmm as K1
from graphaibench_tpu_torch.ops import spmm as tspmm

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
    _, _, tdg = graphs
    a = torch.empty(tdg.nv, 4, device="meta")
    with pytest.raises(NotImplementedError, match="K2"):
        tspmm.sddmm_dot(tdg, a, a)


def test_kernel_build_raises_without_cuda():
    """No fallback: on a host without a CUDA device or nvcc, the kernel
    library's entry raises instead of handing back something else."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the build guard cannot fire")
    with pytest.raises(RuntimeError, match="CUDA|nvcc"):
        _build.load_library()


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
    assert K1.LAUNCHES == before + len(dg.ell)
    # atomics add split rows' pieces in a run-dependent order
    torch.testing.assert_close(out, K1.ell_spmm_plain(dg, wp.fwd, xc),
                               rtol=1e-4, atol=1e-4)
