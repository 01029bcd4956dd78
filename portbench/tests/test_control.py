"""The check's control and faults come out not correct; sound runs correct.

The control is the reference in the precision below the configurations'
float32: TF32 GEMMs (on the CPU, operands rounded to TF32's mantissa). The
faults are planted under a whole run on the CPU: a step that leaves the
state unchanged, half of the training vertices left out with the mean taken
over the rest, and the reported loss altered where it is produced. All are
judged by the cells' own limits."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.inputs import make_inputs
from portbench.reference import check
from portbench.reference import model as ref

WORKLOADS = ["gcn-products.train", "sage-products.train"]


def _control_numbers(cell, device, seed):
    rp, ci = harness.cell_graph(cell, device)
    cfg = cell.cfg
    arch = ref.arch_module(cfg["model"]["arch"])
    inp = make_inputs(cfg, arch, len(rp) - 1, seed, device)
    graph = ref.RefGraph.build(rp, ci, arch, device)

    def traj(p):
        return ref.train_steps(cfg, graph, inp.feats, inp.labels, inp.weights,
                               inp.dropout_seed, 3, precision=p)
    base, low = traj("float32"), traj("tf32")
    return check.training_numbers(low.losses, low.grad1, low.w_after, base)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny_root, workload):
    cell = harness.Cell.load(workload, tiny_root)
    for seed in (11, 2**31 + 12, 2**33 + 13):
        numbers = _control_numbers(cell, torch.device("cpu"), seed)
        ok, _ = check.judge(numbers, cell.limits)
        assert not ok, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(tiny_root, workload, cuda_device):
    cell = harness.Cell.load(workload, tiny_root)
    for seed in (21, 22, 23):
        numbers = _control_numbers(cell, cuda_device, seed)
        ok, _ = check.judge(numbers, cell.limits)
        assert not ok, numbers


def _run(tiny_root, workload):
    res, _ = harness.run_cell(workload, 2**31 + 7, 0.1, False, "cpu",
                              time.perf_counter(), tiny_root)
    return res


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tiny_root, workload):
    assert _run(tiny_root, workload)["correct"] is True


@pytest.mark.parametrize("workload", WORKLOADS)
def test_state_left_unchanged_is_not_correct(tiny_root, workload, monkeypatch):
    from graphaibench_tpu_torch.nn import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self: None)
    res = _run(tiny_root, workload)
    assert res["correct"] is False
    assert res["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_the_batch_left_out_is_not_correct(tiny_root, workload,
                                                monkeypatch):
    from graphaibench_tpu_torch.nn import model

    full = model.masked_softmax_loss

    def half(logits, labels, begin, end, mask=None):
        keep = torch.zeros(logits.shape[0], dtype=torch.uint8,
                           device=logits.device)
        keep[begin:end:2] = 1
        for_grad, reported, probs = full(logits, labels, begin, end, keep)
        return for_grad * (end - begin) / keep.sum(), reported, probs

    monkeypatch.setattr(model, "masked_softmax_loss", half)
    assert _run(tiny_root, workload)["correct"] is False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        tiny_root, workload, monkeypatch):
    """The loss the step reports, off by a thousandth where the loss layer
    produces it."""
    from graphaibench_tpu_torch.nn import model

    full = model.masked_softmax_loss

    def altered(*args, **kw):
        for_grad, reported, probs = full(*args, **kw)
        return for_grad, reported * 1.001, probs

    monkeypatch.setattr(model, "masked_softmax_loss", altered)
    assert _run(tiny_root, workload)["correct"] is False
