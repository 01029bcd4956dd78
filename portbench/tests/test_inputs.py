"""What ``--seed`` makes: the same inputs from the same seed, every seed the
same sizes, weights of any shape an architecture's module names."""

from __future__ import annotations

import math

import torch

from portbench.inputs import make_inputs


class _Arch:
    @staticmethod
    def param_shapes(din, dout):
        return {"W": (din, dout), "alpha": (dout,)}


CFG = {"num_features": 5, "num_classes": 3,
       "model": {"dim_hid": 4, "num_layers": 2}}


def test_same_seed_same_inputs_other_seed_other_values():
    a = make_inputs(CFG, _Arch, 10, 2**31 + 3, "cpu")
    b = make_inputs(CFG, _Arch, 10, 2**31 + 3, "cpu")
    c = make_inputs(CFG, _Arch, 10, 2**31 + 4, "cpu")
    assert torch.equal(a.feats, b.feats) and torch.equal(a.labels, b.labels)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert a.dropout_seed == b.dropout_seed != c.dropout_seed
    assert not torch.equal(a.feats, c.feats)
    assert a.feats.shape == c.feats.shape == (10, 5)
    assert int(a.labels.min()) >= 0 and int(a.labels.max()) < 3


def test_weights_by_name_and_shape_within_glorot():
    w = make_inputs(CFG, _Arch, 10, 7, "cpu").weights
    assert list(w) == ["gconv.0.W", "gconv.0.alpha", "gconv.1.W",
                       "gconv.1.alpha"]
    assert w["gconv.0.W"].shape == (5, 4) and w["gconv.1.W"].shape == (4, 3)
    assert w["gconv.1.alpha"].shape == (3,)
    assert float(w["gconv.0.W"].abs().max()) <= math.sqrt(6 / 9)
    assert float(w["gconv.1.alpha"].abs().max()) <= math.sqrt(6 / 4)
