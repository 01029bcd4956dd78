"""K1's bytes and the step's FLOPs against counts by hand, and the model's
GEMMs against the FLOPs PyTorch counts in one step of the port."""

from __future__ import annotations

import numpy as np
import pytest
from torch.utils.flop_counter import FlopCounterMode

from portbench import workmodel
from portbench.kernels import gemm, k1

DIMS = [100, 256, 256, 47]


def _ops(arch_self_path, nv, ne, train=True):
    return workmodel.step_ops(DIMS, nv, ne, self_path=arch_self_path,
                              train=train)


def test_gcn_step_by_hand():
    nv, ne = 10, 40
    ops = _ops(False, nv, ne)
    # forward: SpMM(100) GEMM(100x256); SpMM(256) GEMM; GEMM(256x47) SpMM(47)
    # backward: layer 2 adjoint SpMM(47), dW, dx; layer 1 dW, dx, adjoint
    # SpMM(256); layer 0 dW alone (the features need no gradient)
    assert [op.f for op in ops if op.kind == "spmm"] == [100, 256, 47, 47, 256]
    gemm_flops = sum(op.flops for op in ops if op.kind == "gemm")
    assert gemm_flops == 2 * nv * (2 * 100 * 256 + 3 * 256 * 256 + 3 * 256 * 47)
    assert workmodel.model_flops(ops) == gemm_flops + 2 * ne * 706
    # K1's bytes: per SpMM x read and the output written once, an id and a
    # weight per edge
    assert sum(k1.work(op)[0] for op in ops if k1.work(op)) == (
        2 * nv * 706 * 4 + 5 * ne * 8)
    assert all(gemm.work(op) is None for op in ops if op.kind == "spmm")
    assert all(k1.work(op) is None for op in ops if op.kind == "gemm")


def test_sage_doubles_the_gemms_over_the_same_spmms():
    nv, ne = 10, 40
    g, s = _ops(False, nv, ne), _ops(True, nv, ne)
    assert ([op.f for op in s if op.kind == "spmm"]
            == [op.f for op in g if op.kind == "spmm"])
    assert (sum(op.flops for op in s if op.kind == "gemm")
            == 2 * sum(op.flops for op in g if op.kind == "gemm"))
    assert gemm.work(workmodel.Op("gemm", m=3, k=4, n=5)) == (
        4 * (12 + 20 + 15), 2 * 60)


def test_products_shape_counts():
    nv, e = 2449029, 123718280
    gcn = workmodel.model_flops(_ops(False, nv, e + nv))
    sage = workmodel.model_flops(_ops(True, nv, e))
    assert gcn == pytest.approx(1.5687e12, rel=1e-3)
    assert sage == pytest.approx(2.9558e12, rel=1e-3)


def test_inference_has_no_backward():
    ops = _ops(False, 10, 40, train=False)
    assert [op.f for op in ops if op.kind == "spmm"] == [100, 256, 47]
    assert len([op for op in ops if op.kind == "gemm"]) == 3


@pytest.mark.parametrize("arch", ["gcn", "sage"])
def test_gemm_flops_match_the_ports_step(arch):
    """FlopCounterMode counts the GEMMs of one training step of the port's
    Model on the CPU; the work model counts the same."""
    from graphaibench_tpu_torch.graph.csr import CSRGraph
    from graphaibench_tpu_torch.graph.io import GnnDataset
    from graphaibench_tpu_torch.nn.layers import ModelConfig
    from graphaibench_tpu_torch.nn.model import Model

    from portbench import graphgen

    rp, ci = graphgen.undirected_csr(
        *graphgen.rmat_draws(13, 4, 0, 0.57, 0.19, 0.19), 1 << 13, "cpu")
    nv = len(rp) - 1
    rng = np.random.default_rng(0)
    mask = np.ones(nv, np.uint8)
    ds = GnnDataset(graph=CSRGraph(rp, ci),
                    feats=rng.standard_normal((nv, 100)).astype(np.float32),
                    labels=rng.integers(0, 47, nv).astype(np.int32),
                    train_mask=mask, val_mask=mask, test_mask=mask,
                    num_classes=47, train_range=(0, 100, 100),
                    val_range=(0, nv, nv), test_range=(0, nv, nv))
    cfg = ModelConfig(arch=arch, num_layers=3, dim_init=100, dim_hid=256,
                      num_cls=47, feat_drop=0.5 if arch == "gcn" else 0.0,
                      lr=0.01)
    m = Model(cfg, ds, device="cpu", seed=1)
    with FlopCounterMode(display=False) as fc:
        m.train_epoch()
    counted = sum(v for op, v in fc.get_flop_counts()["Global"].items()
                  if "mm" in str(op))
    ops = _ops(arch == "sage", nv, 0)
    assert counted == sum(op.flops for op in ops if op.kind == "gemm")
