"""The numbers that decide ``correct``, and their judgement against limits.

Training (the first steps of a cell, program against reference):

* ``loss_gap``: the largest relative gap between the program's reported
  loss and the reference's, over the steps; ``loss1_gap`` the first step's
  alone (before any update, so the later steps' amplified rounding is not
  in it);
* ``grad_gap``: the first step's gradient as the program's Adam got it
  (worked out from its first moment after one step), by the worst leaf:
  the gap between the program's norm of the leaf and the reference's, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same for each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone).

Evaluation: ``acc_gap``, the gap between the program's accuracy and the
reference's.
"""

from __future__ import annotations

import statistics

import torch

LOOSE_LEAF = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _worst_leaf(prog: dict, ref: dict, names) -> float:
    pn = {k: _norm(prog[k]) for k in names}
    rn = {k: _norm(ref[k]) for k in names}
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def training_numbers(prog_losses: list, prog_grad1: dict, prog_w_after: dict,
                     ref) -> dict:
    """``ref`` is the reference's ``Trajectory`` from the same weights."""
    gaps = [abs(p - r) / abs(r)
            for p, r in zip(prog_losses, ref.losses, strict=True)]
    names = list(ref.grad1)
    grad_gap = _worst_leaf(prog_grad1, ref.grad1, names)
    gnorm = {k: _norm(ref.grad1[k]) for k in names}
    med = statistics.median(gnorm.values())
    moving = [k for k in names if gnorm[k] >= LOOSE_LEAF * med]
    change_gap = _worst_leaf(
        {k: prog_w_after[k] - ref.w0[k] for k in moving},
        {k: ref.w_after[k] - ref.w0[k] for k in moving}, moving)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": grad_gap, "change_gap": change_gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit. A number with no limit is reported and not held; a limit whose
    number is missing or not finite fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            ok = False
    for name in limits:
        if name not in numbers:
            checks[name] = {"value": None, "limit": limits[name]}
            ok = False
    return ok, checks
