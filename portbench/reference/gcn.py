"""GCN (Kipf and Welling) as the port's GCN layer states it, in plain PyTorch.

A layer is ``A_hat (x W)`` with ``A_hat = D^-1/2 (A + I) D^-1/2``: a self-loop
on every vertex, each edge weighed by ``1 / sqrt(deg(src) deg(dst))`` over the
degrees with the self-loops, no bias. The product is taken in the cheaper
order (the GEMM first where it narrows the rows the SpMM reads, y > z), which
changes the rounding and nothing else.
"""

from __future__ import annotations

import torch

from portbench import workmodel

SELF_LOOPS = True


def param_shapes(din: int, dout: int) -> dict:
    """A layer's weights by the port's parameter names."""
    return {"W_neigh": (din, dout)}


def step_ops(dims: list, nv: int, ne: int, train: bool) -> list:
    """The work of one step (``workmodel``): the SpMMs run over the edges
    and the self-loops."""
    return workmodel.step_ops(dims, nv, ne + nv, self_path=False, train=train)


def edge_weights(src: torch.Tensor, dst: torch.Tensor,
                 deg: torch.Tensor) -> torch.Tensor:
    vn = torch.where(deg > 0, 1.0 / torch.sqrt(deg.to(torch.float32)),
                     torch.zeros((), device=deg.device))
    return vn[src] * vn[dst]


def layer(w: dict, x: torch.Tensor, agg, mm) -> torch.Tensor:
    """One layer before its activation; ``w`` holds the layer's weights by
    name, ``agg`` is the SpMM with ``A_hat``, ``mm`` the GEMM."""
    W = w["W_neigh"]
    if x.shape[1] > W.shape[1]:
        return agg(mm(x, W))
    return mm(agg(x), W)
