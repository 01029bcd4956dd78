"""The training Model.

Counterpart of ``graphaibench_tpu/nn/model.py``: graph preparation per
architecture (self-loops for all but SAGE — net.cpp:96; the inductive
masked training graph — net.cpp:161-164), the static aggregation weights,
the full-batch epoch loop with the reference's metric lines
(train_loss/train_acc/val_acc, epoch/s — net.cpp:361-419), GraphSAINT
subgraph-sampled training (net.cpp:288-358), checkpoints and stage
timers, for GCN, GraphSAGE, GAT and GGNN with any of the reference's
seven optimizers. Steps run eagerly on an explicit ``device``.

``train_epochs`` batched epochs into one TPU dispatch and has no
counterpart here.
"""

from __future__ import annotations

import concurrent.futures
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
from graphaibench_tpu_torch.nn.sampler import SaintSampler
from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.ops.device_graph import (
    DeviceGraph,
    PackedEdgeW,
    coo_device_graph,
    pack_edge_values,
    to_device_graph,
)
from graphaibench_tpu_torch.ops.spmm import _pick_impl
from graphaibench_tpu_torch.utils import timers as timers_mod
from graphaibench_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)


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


def pad_subgraph(sampler: SaintSampler, arch: str, subg_size: int, seed: int,
                 n_pad: int, e_pad: int, feats_np: np.ndarray,
                 labels_np: np.ndarray) -> dict:
    """Host work of one sampled step: sample + induce + pad to fixed
    shapes (n_pad, e_pad), so that every step's tensors have the sizes of
    the last one's and the caching allocator reuses its blocks. Mirrors
    the reference's construct_subg_feats/labels + graph swap
    (net.cpp:288-358). Returns padded numpy arrays; ``e_pad`` in the
    result may have grown (rounded up to 64) when the sample's edge count
    exceeded the requested pad."""
    sub, l2g, _mask = sampler.generate_subgraph(subg_size, seed)
    sub = prepare_graph(sub, arch)
    n_real, e_real = sub.nv, sub.ne
    if e_real > e_pad:
        e_pad = -(-e_real // 64) * 64
    w = aggregation_weights(sub, arch)
    src, dst = sub.coo()
    es = np.full(e_pad, n_pad - 1, dtype=np.int32)
    cd = np.zeros(e_pad, dtype=np.int32)
    ww = np.zeros(e_pad, dtype=np.float32)
    es[:e_real], cd[:e_real] = src, dst
    # for GAT edge_w is the validity mask; others carry norms
    ww[:e_real] = 1.0 if arch == "gat" else w
    tp = np.arange(e_pad, dtype=np.int32)
    tp[:e_real] = T.transpose_edge_permutation(sub)
    deg = np.zeros(n_pad, dtype=np.int32)
    deg[:n_real] = sub.degrees()
    x = np.zeros((n_pad, feats_np.shape[1]), dtype=np.float32)
    x[:n_real] = feats_np[l2g]
    lab = np.zeros(n_pad, dtype=np.int32)
    lab[:n_real] = labels_np[l2g]
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n_real] = True
    return dict(e_pad=e_pad, n_real=n_real, es=es, cd=cd, ww=ww,
                tp=tp, deg=deg, x=x, lab=lab, valid=valid)


class Model:
    """End-to-end trainer. Usage:

        model = Model(cfg, dataset, device="cuda")
        model.train(num_epochs)            # or model.train_sampled(...)
        acc = model.evaluate("test")

    ``inductive`` trains on the subgraph of the train-masked vertices and
    evaluates on the full graph. ``seed`` seeds the dropout masks' generator.
    ``timers`` (a ``utils.timers.OpTimers``) collects the stage breakdown
    (train.cpp:60-76).

    ``train`` and ``train_sampled`` return one (loss, accuracy, seconds)
    per epoch, where the JAX package's ``Model`` returns the total seconds:
    the total is ``sum(dt for _, _, dt in log)``.
    """

    def __init__(self, cfg: ModelConfig, data: GnnDataset, *, device,
                 inductive: bool = False, seed: int = 0, timers=None):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}: one of "
                             f"{sorted(OPTIMIZERS)}")
        self.cfg = cfg
        self.data = data
        self.inductive = inductive
        self.timers = timers
        self.device = torch.device(device)
        self.full = GraphBundle.build(data.graph, cfg.arch, device=self.device,
                                      spmm_impl=cfg.spmm_impl)
        if inductive:
            masked = T.masked_subgraph(data.graph, data.train_mask)
            self.training = GraphBundle.build(masked, cfg.arch,
                                              device=self.device,
                                              spmm_impl=cfg.spmm_impl)
        else:
            self.training = self.full
        self.params = init_params(cfg, device=self.device)
        self.opt = OPTIMIZERS[cfg.optimizer](self.params.parameters(),
                                             lr=cfg.lr)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

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
        logits = apply_model(self.cfg, self.params, self.training.device,
                             self.training.edge_w_agg, self.feats, train=True,
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
        """Run ``num_epochs`` steps; returns (loss, acc, seconds) per epoch
        (a list, not the JAX ``Model.train``'s total seconds, which is the
        sum of the third entries). Each epoch's time ends when its loss
        reaches the host, which waits for the device."""
        log = []
        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            loss, acc = self.train_epoch()
            dt = time.perf_counter() - t0
            log.append((loss, acc, dt))
            if self.timers is not None:
                self.timers.add(timers_mod.OP_STEP, dt)
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

    def _sampled_step(self, d: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """One step on a padded subgraph (``pad_subgraph``'s arrays):
        returns (loss, accuracy) as device scalars, both from the forward
        pass before the update. The loss is the step's own,
        sum of CE over the real vertices / their number, and the forward
        draws no dropout, whatever the drop rates, as the JAX package's
        sampled step (which hands ``apply_model`` no key)."""
        dev = self.device
        n_pad = len(d["valid"])
        dg = coo_device_graph(d["es"], d["cd"], d["tp"], d["deg"], nv=n_pad,
                              device=dev)
        edge_w = torch.from_numpy(d["ww"]).to(dev)
        x = torch.from_numpy(d["x"]).to(dev)
        lab = torch.from_numpy(d["lab"]).to(dev)
        valid = torch.from_numpy(d["valid"]).to(dev)
        self.opt.zero_grad()
        logits = apply_model(self.cfg, self.params, dg, edge_w, x, train=True)
        probs = torch.softmax(logits, dim=-1)
        # a label outside [0, classes) has an all-zero row, as one_hot gives it
        onehot = (lab[:, None] == torch.arange(logits.shape[-1], device=dev)
                  ).to(logits.dtype)
        ce = torch.where(valid, gmath.cross_entropy(onehot, probs),
                         torch.zeros((), device=dev))
        loss = ce.sum() / float(d["n_real"])
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            acc = gmath.masked_accuracy_single(logits, lab, valid)
        return loss.detach(), acc

    def train_sampled(self, num_epochs: int, subg_size: int, *,
                      val_interval: int = 50, verbose: bool = True,
                      seed: int = 0) -> list[tuple[float, float, float]]:
        """GraphSAINT subgraph-sampled training (Model::subgraph_sampling,
        net.cpp:288-358): each epoch trains on a fresh frontier-sampled
        subgraph of ~subg_size vertices of the training graph; evaluation
        uses the full graph. A one-thread pool samples and pads epoch
        k+1's subgraph while epoch k's step runs. Returns (loss, acc,
        seconds) per epoch (a list, not the JAX ``Model.train_sampled``'s
        total seconds, which is the sum of the third entries)."""
        sampler = SaintSampler(self.data.graph, self.training.host,
                               self.data.train_mask)
        n_pad = -(-subg_size // 8) * 8
        host = self.training.host
        avg_deg = max(host.ne // max(host.nv, 1), 1)
        e_pad = -(-(n_pad * (avg_deg + 2)) // 64) * 64
        feats_np = np.asarray(self.data.feats)
        labels_np = np.asarray(self.data.labels)

        def prepare(epoch, e_pad):
            return pad_subgraph(sampler, self.cfg.arch, subg_size,
                                seed + epoch, n_pad, e_pad, feats_np,
                                labels_np)

        log = []
        pool = concurrent.futures.ThreadPoolExecutor(1)
        try:
            fut = pool.submit(prepare, 0, e_pad)
            for epoch in range(num_epochs):
                t0 = time.perf_counter()
                d = fut.result()
                if self.timers is not None:
                    # sampler wait NOT hidden behind the previous step
                    self.timers.add(timers_mod.OP_SAMPLE,
                                    time.perf_counter() - t0)
                e_pad = d["e_pad"]
                if epoch + 1 < num_epochs:   # double-buffer the sampler
                    fut = pool.submit(prepare, epoch + 1, e_pad)
                t_step = time.perf_counter()
                loss, acc = self._sampled_step(d)
                loss, acc = float(loss), float(acc)   # waits for the device
                if self.timers is not None:
                    self.timers.add(timers_mod.OP_STEP,
                                    time.perf_counter() - t_step)
                dt = time.perf_counter() - t0
                log.append((loss, acc, dt))
                if verbose:
                    line = (f"Epoch {epoch:3d} subg_nv {d['n_real']} train_loss "
                            f"{loss:.3f} train_acc {acc:.3f}")
                    if epoch % val_interval == 0 and epoch != 0:
                        line += f" val_acc {self.evaluate('val'):.3f}"
                    print(f"{line} time {dt:.4f} s")
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        return log

    def save(self, path: str, *, step: int = 0) -> str:
        """Checkpoint parameters + optimizer state to
        ``<path>/step_<step>.pt``; returns the file's path."""
        return save_checkpoint(path, {"params": self.params.state_dict(),
                                      "opt_state": self.opt.state_dict()},
                               step=step)

    def restore(self, path: str, *, step: int = 0) -> None:
        """Resume from a checkpoint written by :meth:`save`, onto the
        model's device."""
        state = restore_checkpoint(path, step=step, device=self.device)
        self.params.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])

    @torch.no_grad()
    def evaluate(self, split: str = "test") -> float:
        t0 = time.perf_counter()
        logits = apply_model(self.cfg, self.params, self.full.device,
                             self.full.edge_w_agg, self.feats, train=False,
                             trivial_w=True)
        probs = torch.sigmoid(logits) if self.cfg.is_sigmoid else None
        acc = float(self._accuracy(logits, probs,
                                   self._valid(split, logits.shape[0])))
        if self.timers is not None:   # float() above waited for the device
            self.timers.add(timers_mod.OP_EVAL, time.perf_counter() - t0)
        return acc
