"""The full-batch training Model.

Counterpart of ``graphaibench_tpu/nn/model.py``: graph preparation per
architecture (self-loops for all but SAGE — net.cpp:96), the static
aggregation weights, and the epoch loop with the reference's metric lines
(train_loss/train_acc/val_acc, epoch/s — net.cpp:361-419), for GCN,
GraphSAGE, GAT and GGNN with any of the reference's seven optimizers.
Steps run eagerly on an explicit ``device``.

Not ported yet: ``train_sampled`` (GraphSAINT, ROADMAP P9), inductive
training and save/restore (P6), timers (P10). ``train_epochs`` batched
epochs into one TPU dispatch and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from graphaibench_tpu_torch.graph import transforms as T
from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.graph.io import GnnDataset
from graphaibench_tpu_torch.nn.layers import ModelConfig, apply_model, init_params
from graphaibench_tpu_torch.nn.losses import masked_sigmoid_loss, masked_softmax_loss
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.ops.device_graph import (
    DeviceGraph,
    PackedEdgeW,
    pack_edge_values,
    to_device_graph,
)
from graphaibench_tpu_torch.ops.spmm import _pick_impl


def prepare_graph(g: CSRGraph, arch: str) -> CSRGraph:
    """Selfloop insertion for all archs except SAGE (net.cpp:96)."""
    return g if arch == "sage" else T.add_selfloop(g)


def aggregation_weights(g: CSRGraph, arch: str) -> np.ndarray:
    """Static per-edge aggregation weights by architecture."""
    if arch == "gcn":
        return T.gcn_edge_norms(g)
    if arch == "sage":
        return T.sage_edge_norms(g)
    return np.ones(g.ne, dtype=np.float32)


@dataclasses.dataclass
class GraphBundle:
    """A prepared graph, its device form and its static aggregation
    weights. ``packed_w`` pre-gathers the weights per ELL bucket when the
    ELL strategy will run (more than 4096 vertices): every SpMM then
    reads its weights in slot order instead of gathering them by edge id."""

    host: CSRGraph
    device: DeviceGraph
    edge_w: torch.Tensor
    packed_w: PackedEdgeW | None = None

    @property
    def edge_w_agg(self):
        """What aggregation call sites pass as per-edge weights."""
        return self.packed_w if self.packed_w is not None else self.edge_w

    @classmethod
    def build(cls, g: CSRGraph, arch: str, *, device,
              spmm_impl: str = "auto") -> "GraphBundle":
        prepped = prepare_graph(g, arch)
        dg = to_device_graph(prepped, device=device)
        edge_w = torch.from_numpy(aggregation_weights(prepped, arch)).to(device)
        packed = None
        if (arch != "gat" and dg.has_ell_layout and prepped.nv > 4096
                and _pick_impl(dg, spmm_impl) == "ell"):
            packed = pack_edge_values(dg, edge_w)
        return cls(host=prepped, device=dg, edge_w=edge_w, packed_w=packed)


class Model:
    """End-to-end full-batch trainer. Usage:

        model = Model(cfg, dataset, device="cuda")
        model.train(num_epochs)
        acc = model.evaluate("test")
    """

    def __init__(self, cfg: ModelConfig, data: GnnDataset, *, device):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}: one of "
                             f"{sorted(OPTIMIZERS)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.full = GraphBundle.build(data.graph, cfg.arch, device=self.device,
                                      spmm_impl=cfg.spmm_impl)
        self.params = init_params(cfg, device=self.device)
        self.opt = OPTIMIZERS[cfg.optimizer](self.params.parameters(),
                                             lr=cfg.lr)
        self.generator = torch.Generator(device=self.device).manual_seed(0)

        self.feats = torch.from_numpy(
            np.ascontiguousarray(data.feats, np.float32)).to(self.device)
        lab_dtype = np.float32 if cfg.is_sigmoid else np.int64
        self.labels = torch.from_numpy(
            np.asarray(data.labels).astype(lab_dtype)).to(self.device)
        self.masks = {
            name: torch.from_numpy(np.asarray(m)).to(self.device)
            for name, m in (("train", data.train_mask),
                            ("val", data.val_mask),
                            ("test", data.test_mask))
        }
        self.ranges = {
            "train": data.train_range,
            "val": data.val_range,
            "test": data.test_range,
        }

    def _valid(self, split: str, n: int) -> torch.Tensor:
        begin, end, _ = self.ranges[split]
        idx = torch.arange(n, device=self.device)
        return (idx >= begin) & (idx < end) & (self.masks[split] != 0)

    def _accuracy(self, logits, probs, valid) -> torch.Tensor:
        if self.cfg.is_sigmoid:
            return gmath.masked_f1_micro(probs, self.labels, valid)
        return gmath.masked_accuracy_single(logits, self.labels, valid)

    def train_epoch(self) -> tuple[float, float]:
        """One full-batch step; returns (reported loss, train accuracy),
        both from the forward pass before the update."""
        begin, end, _ = self.ranges["train"]
        self.opt.zero_grad()
        logits = apply_model(self.cfg, self.params, self.full.device,
                             self.full.edge_w_agg, self.feats, train=True,
                             generator=self.generator, trivial_w=True)
        loss_fn = masked_sigmoid_loss if self.cfg.is_sigmoid else masked_softmax_loss
        lg, rep, probs = loss_fn(logits, self.labels, begin, end,
                                 self.masks["train"])
        lg.backward()
        self.opt.step()
        with torch.no_grad():
            acc = self._accuracy(logits, probs,
                                 self._valid("train", logits.shape[0]))
        return float(rep.detach()), float(acc)

    def train(self, num_epochs: int, *, val_interval: int = 50,
              verbose: bool = True) -> list[tuple[float, float, float]]:
        """Run ``num_epochs`` steps; returns (loss, acc, seconds) per epoch.
        Each epoch's time ends when its loss reaches the host, which
        waits for the device."""
        log = []
        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            loss, acc = self.train_epoch()
            dt = time.perf_counter() - t0
            log.append((loss, acc, dt))
            if verbose:
                line = f"Epoch {epoch:3d} train_loss {loss:.3f} train_acc {acc:.3f}"
                if epoch % val_interval == 0 and epoch != 0:
                    line += f" val_acc {self.evaluate('val'):.3f}"
                print(f"{line} time {dt:.4f} s")
        total = sum(dt for _, _, dt in log)
        if verbose and num_epochs:
            print(
                f"Average training time per epoch: {total / num_epochs:.5f} "
                f"seconds. Throughput {num_epochs / max(total, 1e-12):.2f} epoch/s"
            )
        return log

    @torch.no_grad()
    def evaluate(self, split: str = "test") -> float:
        logits = apply_model(self.cfg, self.params, self.full.device,
                             self.full.edge_w_agg, self.feats, train=False,
                             trivial_w=True)
        probs = torch.sigmoid(logits) if self.cfg.is_sigmoid else None
        return float(self._accuracy(logits, probs,
                                    self._valid(split, logits.shape[0])))
