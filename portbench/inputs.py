"""What ``--seed`` makes: features, labels and initial weights.

All of it comes from one ``torch.Generator`` on the run's device, in a few
large calls, so the same seed gives the same inputs, and the program and the
reference are handed the same tensors. Every seed gives the same sizes: the
training split is the first ``train_nodes`` vertices, as the reference's
datasets give it (a mask range), whatever the seed.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Inputs:
    feats: torch.Tensor            # (nv, num_features) float32
    labels: torch.Tensor           # (nv,) int64 in [0, num_classes)
    weights: dict[str, torch.Tensor]   # initial weights by parameter name
    dropout_seed: int              # seeds the program's dropout generator


def layer_dims(cfg: dict) -> list[int]:
    """Widths from the input features through each layer to the classes."""
    m = cfg["model"]
    return ([cfg["num_features"]] + [m["dim_hid"]] * (m["num_layers"] - 1)
            + [cfg["num_classes"]])


def param_shapes(cfg: dict, arch) -> dict[str, tuple]:
    """Each weight of the configuration's model by the name the port's
    parameters have (``gconv.{l}.<name>``), in the port's order, with the
    shape the architecture's module (``reference/<arch>.py``) gives it."""
    dims = layer_dims(cfg)
    return {f"gconv.{l}.{n}": shape for l in range(len(dims) - 1)
            for n, shape in arch.param_shapes(dims[l], dims[l + 1]).items()}


def make_inputs(cfg: dict, arch, nv: int, seed: int, device) -> Inputs:
    """Normal features, uniform labels and Glorot-uniform weights from
    ``seed`` (a vector's fans are its length and 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((nv, cfg["num_features"]), generator=gen,
                        device=device)
    labels = torch.randint(0, cfg["num_classes"], (nv,), generator=gen,
                           device=device)
    shapes = param_shapes(cfg, arch)
    flat = torch.rand(sum(math.prod(s) for s in shapes.values()),
                      generator=gen, device=device)
    weights, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        limit = math.sqrt(6.0 / (shape[0] + (shape[1] if len(shape) > 1 else 1)))
        weights[name] = ((flat[at:at + n] * 2 - 1) * limit).view(shape)
        at += n
    return Inputs(feats, labels, weights, dropout_seed=seed + 1)
