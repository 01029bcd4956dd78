"""Nearest-neighbour search over vertex embeddings.

Counterpart of ``graphaibench_tpu/analytics/ann.py``: the reference's ANN
benchmark (src/nearest_neighbor_search/ann.h:5-24) builds random embeddings
and answers queries; its solvers are stubs. This is a brute-force exact kNN,
one (Q, D) x (D, N) product and a top-k on the device. The product is a
plain ``torch.matmul``, as the JAX package leaves it to XLA, in full float32
(TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch


def knn_search(embeddings: np.ndarray, queries: np.ndarray, k: int = 10, *,
               metric: str = "l2", device="cuda"):
    """Returns (indices (Q, k), scores (Q, k)) as numpy, best first: the
    inner product (``ip``), the cosine (``cos``) or the negative squared L2
    distance up to the query's own norm (``l2``)."""
    x = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32)).to(device)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(device)
    if metric == "ip":
        scores = q @ x.T
    elif metric == "cos":
        xn = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp(min=1e-12)
        qn = q / torch.linalg.norm(q, dim=1, keepdim=True).clamp(min=1e-12)
        scores = qn @ xn.T
    else:  # negative squared L2 via the matmul expansion
        scores = 2.0 * (q @ x.T) - (x * x).sum(1)[None, :]
    top, idx = torch.topk(scores, k, dim=1)
    return idx.to(torch.int32).cpu().numpy(), top.cpu().numpy()
