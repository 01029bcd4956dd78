"""Entry hook of the port.

entry()  -> (fn, example_args): the single-device forward step of the
            flagship model (2-layer GCN, full batch) on a toy graph, the
            counterpart of ``__graft_entry__.entry()`` beside the JAX
            package: the same graph, features, config and parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.graph.generators import rmat
from graphaibench_tpu_torch.nn.layers import ModelConfig, apply_model, init_params
from graphaibench_tpu_torch.nn.model import GraphBundle


def entry(device="cuda"):
    """The forward function of the flagship model and its example
    arguments ``(params, x)``, graph and tensors on ``device``: rmat(10, 8)
    seed 0, 64 standard-normal features, 128 hidden, 8 classes."""
    g = rmat(10, 8, seed=0)
    feats = np.random.default_rng(0).standard_normal((g.nv, 64)).astype(np.float32)
    cfg = ModelConfig(arch="gcn", num_layers=2, dim_init=64, dim_hid=128,
                      num_cls=8, lr=0.02)
    params = init_params(cfg, device=device)
    gb = GraphBundle.build(g, cfg.arch, device=device)

    def forward(params, x):
        return apply_model(cfg, params, gb.device, gb.edge_w, x)

    return forward, (params, torch.from_numpy(feats).to(device))
