"""The system under test: the port's ``Model``, built from what the benchmark
made, and the calls the window drives.

This is the one module of the benchmark that imports the program
(``graphaibench_tpu_torch``). The program gets the raw graph, the features,
the labels, the split and the seeded initial weights; its set-up derives
the rest (self-loops, edge weights, the device graph, the optimizer state).
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.graph.io import GnnDataset
from graphaibench_tpu_torch.nn.layers import ModelConfig
from graphaibench_tpu_torch.nn.model import Model


def model_config(cfg: dict) -> ModelConfig:
    m = cfg["model"]
    return ModelConfig(arch=m["arch"], num_layers=m["num_layers"],
                       dim_init=cfg["num_features"], dim_hid=m["dim_hid"],
                       num_cls=cfg["num_classes"],
                       feat_drop=m.get("feat_drop", 0.0), lr=m["lr"],
                       optimizer=m["optimizer"])


class Program:
    """One ``Model`` on the configuration's graph and the seed's inputs
    (features and labels as host arrays, as a dataset hands them over; the
    initial weights by parameter name)."""

    def __init__(self, cfg: dict, row_ptr: np.ndarray, col_idx: np.ndarray,
                 feats: np.ndarray, labels: np.ndarray, weights: dict,
                 dropout_seed: int, device):
        g = CSRGraph(row_ptr=row_ptr, col_idx=col_idx)
        nv, n_train = g.nv, cfg["train_nodes"]
        mask = np.ones(nv, dtype=np.uint8)
        rest = (n_train, nv, nv - n_train)
        ds = GnnDataset(
            graph=g, feats=feats, labels=labels.astype(np.int32),
            train_mask=mask, val_mask=mask, test_mask=mask,
            num_classes=cfg["num_classes"],
            train_range=(0, n_train, n_train), val_range=rest,
            test_range=rest)
        self.model = Model(model_config(cfg), ds, device=device,
                           seed=dropout_seed)
        named = dict(self.model.params.named_parameters())
        if set(named) != set(weights):
            raise ValueError(f"the program's parameters {sorted(named)} are not "
                             f"the benchmark's {sorted(weights)}")
        with torch.no_grad():
            for name, w in weights.items():
                named[name].copy_(w)

    def step(self, kind: str) -> float:
        """One step of the mix's kind, the loss or the accuracy it reports
        (its result on the host, so the step has ended on the device)."""
        if kind == "train":
            return self.model.train_epoch()[0]
        if kind == "evaluate":
            return self.model.evaluate("test")
        raise ValueError(f"unknown step kind {kind!r}")

    def first_gradient(self) -> dict:
        """The gradient the optimizer got in its one step so far, from its
        first moment: m = (1 - b1) g."""
        opt = self.model.opt
        return {name: m.detach() / (1 - opt.b1)
                for (name, _), m in zip(self.model.params.named_parameters(),
                                        opt.m)}

    def weights(self) -> dict:
        return {name: p.detach().clone()
                for name, p in self.model.params.named_parameters()}
