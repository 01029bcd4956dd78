"""GraphSAGE with the mean aggregator (Hamilton et al.), as the port's SAGE
layer states it, in plain PyTorch.

A layer is ``mean_{u in N(v)} x_u W_neigh + x_v W_self``: no self-loops, each
edge weighed by ``1 / deg(src)``, the neighbour and self paths summed (the
reference's concatenation followed by one GEMM), no bias. The neighbour
path's product is taken in the cheaper order, as in ``gcn.py``.
"""

from __future__ import annotations

import torch

from portbench import workmodel

SELF_LOOPS = False


def param_shapes(din: int, dout: int) -> dict:
    """A layer's weights by the port's parameter names."""
    return {"W_neigh": (din, dout), "W_self": (din, dout)}


def step_ops(dims: list, nv: int, ne: int, train: bool) -> list:
    """The work of one step (``workmodel``), the self path's GEMMs with it."""
    return workmodel.step_ops(dims, nv, ne, self_path=True, train=train)


def edge_weights(src: torch.Tensor, dst: torch.Tensor,
                 deg: torch.Tensor) -> torch.Tensor:
    inv = torch.where(deg > 0, 1.0 / deg.to(torch.float32),
                      torch.zeros((), device=deg.device))
    return inv[src]


def layer(w: dict, x: torch.Tensor, agg, mm) -> torch.Tensor:
    W = w["W_neigh"]
    neigh = agg(mm(x, W)) if x.shape[1] > W.shape[1] else mm(agg(x), W)
    return neigh + mm(x, w["W_self"])
