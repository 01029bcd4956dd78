"""Collaborative filtering: latent-factor matrix completion.

Counterpart of ``graphaibench_tpu/analytics/cf.py``, the reference's
gather-apply two-phase SGD (src/embedding/omp_base.cc:15-77, defaults
main.cc:6-10: K=20, lambda=0.001, step=3.5e-7, max_iters=5): per iteration
every vertex accumulates err[u] = sum over ratings (r_uv - <p_u, p_v>) * p_v,
then p_u += step * (-lambda * p_u + err[u]).

The per-edge estimate is ``sddmm_dot`` (the kernel ``sddmm_dot_ell`` on a
CUDA graph) and the accumulation an SpMM with per-edge weights, the errors
(K1 on a CUDA graph, ``ops/spmm.py::spmm_ell``): no (E, K) gather is
formed on the card. Both read the ratings and the errors by CSR edge id,
which the ELL slots carry.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.graph.csr import CSRGraph
from graphaibench_tpu_torch.ops.device_graph import to_device_graph
from graphaibench_tpu_torch.ops.rng import uniform_reference
from graphaibench_tpu_torch.ops.spmm import sddmm_dot, spmm_ell

K = 20          # latent dimension (common.h:85)
LAMBDA = 0.001
STEP = 0.00000035
MAX_ITERS = 5
CF_EPSILON = 0.1


def init_latents(nv: int, k: int = K) -> np.ndarray:
    """The reference reseeds default_random_engine() per vertex
    (main.cc:15-30) so every row is identical; reproduce that quirk."""
    row = uniform_reference(1, k, 0.0, 1.0)  # default-constructed == seed 1
    return np.tile(row, (nv, 1)).astype(np.float32)


def cf_train(g: CSRGraph, ratings: np.ndarray, *, k: int = K,
             lam: float = LAMBDA, step: float = STEP,
             max_iters: int = MAX_ITERS, epsilon: float = CF_EPSILON,
             latents: np.ndarray | None = None, device="cuda"):
    """Returns (latents as numpy, rmse_history). ``g`` is the bipartite graph
    with edges stored in both directions; ``ratings`` per edge in CSR
    order."""
    dg = to_device_graph(g, device=device, with_transpose=False)
    r = torch.from_numpy(np.asarray(ratings, dtype=np.float32)).to(device)
    lat = torch.from_numpy(np.ascontiguousarray(
        latents if latents is not None else init_latents(g.nv, k),
        np.float32)).to(device)
    history = []
    with torch.no_grad():
        for _ in range(max_iters):
            est = sddmm_dot(dg, lat, lat)
            delta = r - est
            if dg.has_ell_layout:
                err = spmm_ell(dg, delta, lat)
            else:
                err = torch.zeros_like(lat)
            lat = lat + step * (-lam * lat + err)
            rmse = torch.sqrt(torch.sum(delta * delta) / dg.ne)
            history.append(float(rmse))
            if history[-1] < epsilon:
                break
    return lat.cpu().numpy(), history
