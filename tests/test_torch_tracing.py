"""The port's spans (``utils/timers.py::span``) in a CPU ``torch.profiler``
trace: the phases of ``Model.train_epoch``, dropout, K1's adjoint and the
set-up stages, nested as designed; and no ``record_function`` at all while
no profiler runs."""

import numpy as np
import pytest
import torch

from graphaibench_tpu_torch.graph.generators import rmat
from graphaibench_tpu_torch.graph.io import GnnDataset
from graphaibench_tpu_torch.nn.layers import ModelConfig
from graphaibench_tpu_torch.nn.model import Model
from graphaibench_tpu_torch.utils import timers

torch.set_num_threads(2)

PHASES = ("gab.forward", "gab.backward", "gab.optimizer", "gab.report")


@pytest.fixture(scope="module")
def dataset():
    # more than 4,096 vertices: the packed ELL path (``_SpmmPacked``) runs
    g = rmat(13, 4, seed=3)
    rng = np.random.default_rng(0)
    nv, half = g.nv, g.nv // 2
    ones = np.ones(nv, dtype=np.uint8)
    return GnnDataset(
        graph=g, feats=rng.standard_normal((nv, 8)).astype(np.float32),
        labels=rng.integers(0, 4, nv).astype(np.int32),
        train_mask=ones, val_mask=ones, test_mask=ones, num_classes=4,
        train_range=(0, half, half), val_range=(half, nv, nv - half),
        test_range=(half, nv, nv - half))


def _model(arch, ds):
    cfg = ModelConfig(arch=arch, num_layers=3, dim_init=8, dim_hid=16,
                      num_cls=4, feat_drop=0.5 if arch == "gcn" else 0.0,
                      spmm_impl="ell")
    return Model(cfg, ds, device="cpu", seed=1)


def _spans(prof):
    """(name, start_us, end_us) of the trace's ``gab.`` ranges, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("gab.")),
                  key=lambda s: s[1])


def _inside(spans, outer, name):
    return [s for s in spans
            if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


@pytest.mark.parametrize("arch,drops", [("gcn", 3), ("sage", 0)])
def test_train_epoch_spans_nest_as_designed(dataset, arch, drops):
    model = _model(arch, dataset)
    assert model.training.packed_w is not None
    model.train_epoch()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            model.train_epoch()
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "gab.train_epoch"]
    assert len(steps) == 2
    for step in steps:
        phases = {p: _inside(spans, step, p) for p in PHASES}
        assert all(len(v) == 1 for v in phases.values()), phases
        order = [phases[p][0] for p in PHASES]
        assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
        fwd, bwd = phases["gab.forward"][0], phases["gab.backward"][0]
        # the layer-0 SpMM reads the features: no adjoint
        assert len(_inside(spans, step, "gab.spmm.adjoint")) == 2
        assert len(_inside(spans, bwd, "gab.spmm.adjoint")) == 2
        assert len(_inside(spans, step, "gab.dropout")) == drops
        assert len(_inside(spans, fwd, "gab.dropout")) == drops
    names = {s[0] for s in spans}
    assert names == {"gab.train_epoch", *PHASES, "gab.spmm.adjoint"} | (
        {"gab.dropout"} if drops else set())


def test_setup_spans(dataset):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _model("gcn", dataset)
    spans = _spans(prof)
    assert [s[0] for s in spans] == [
        "gab.setup.prepare_graph", "gab.setup.device_graph",
        "gab.setup.edge_norms", "gab.setup.pack_edge_values",
        "gab.setup.params", "gab.setup.inputs"]


def test_span_enters_nothing_without_a_profiler(dataset, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    model = _model("gcn", dataset)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert timers.span("gab.forward") is timers.span("gab.backward")
    with timers.span("gab.forward"):
        pass
    loss, _ = model.train_epoch()
    assert np.isfinite(loss)
    with pytest.raises(AssertionError):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with timers.span("gab.forward"):
                pass
