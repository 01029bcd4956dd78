"""Random-walk vertex embeddings: DeepWalk and node2vec.

Counterpart of ``graphaibench_tpu/analytics/embedding.py`` (the reference
lists these as planned-but-absent, src/embedding/README.md:50-54): walks from
the walkers of ``khop.py``, then skip-gram with negative sampling, each step
a pair of embedding-row gathers, batched dot products and scatter-adds
(``index_add_``) on the graph's device.

node2vec biases the walk with the standard p/q second-order rule (return
parameter p, in-out parameter q) by rejection, as JAX: 8 rounds of a
candidate and a uniform draw, the first accepted candidate taken, and an
unbiased candidate where none is. Membership of a candidate in N(prev) is a
batched binary search over prev's sorted CSR segment, where JAX searches a
sentinel-padded (nv, max_deg) table. The draws come from a
``torch.Generator``; ``_node2vec_step`` and ``_train_skipgram`` take them as
arguments, so that a test can feed them JAX's. The initial embeddings and
the pair order are numpy's, bit-equal to JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from graphaibench_tpu_torch.analytics.khop import (
    WalkGraph,
    _neighbour,
    random_walk,
    uniform_below,
    walk_graph,
)
from graphaibench_tpu_torch.graph.csr import CSRGraph

REJECTION_ROUNDS = 8


def _in_row(wg: WalkGraph, v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x in N(v), elementwise, by a binary search over v's sorted CSR
    segment."""
    if wg.col_idx.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    lo = wg.row_ptr[v]
    hi = lo + wg.deg[v]
    last = wg.col_idx.numel() - 1
    for _ in range(max(wg.max_deg, 1).bit_length()):
        mid = (lo + hi) >> 1
        go = (lo < hi) & (wg.col_idx[mid.clamp(max=last)] < x)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go | (lo >= hi), hi, mid)
    return (lo < wg.row_ptr[v] + wg.deg[v]) & (wg.col_idx[lo.clamp(max=last)] == x)


def _node2vec_step(wg: WalkGraph, prev: torch.Tensor, cur: torch.Tensor,
                   r0: torch.Tensor, rs, us, *, p: float, q: float):
    """One step of every walk at ``cur`` having come from ``prev``: ``r0``
    the fallback's draw, ``rs`` and ``us`` the rejection rounds' candidate
    draws and uniforms (``REJECTION_ROUNDS`` of each, shaped like cur)."""
    w_max = max(1.0, 1.0 / p, 1.0 / q)
    out = _neighbour(wg, cur, r0)
    accepted = torch.zeros_like(cur, dtype=torch.bool)
    for r, u in zip(rs, us):
        cand = _neighbour(wg, cur, r)
        # bias: 1/p if cand == prev; 1 if cand in N(prev); else 1/q
        wgt = torch.where(cand == prev, 1.0 / p,
                          torch.where(_in_row(wg, prev, cand), 1.0, 1.0 / q))
        ok = (u * w_max <= wgt) & ~accepted
        out = torch.where(ok, cand, out)
        accepted |= ok
    return torch.where(wg.deg[cur] > 0, out, cur)


def node2vec_walks(g: CSRGraph, starts: np.ndarray, walk_length: int, *,
                   p: float = 1.0, q: float = 1.0, seed: int = 0,
                   device="cuda") -> np.ndarray:
    """(num_walks, walk_length+1) int32 second-order biased walks.

    Transition weights from v (having arrived from t): 1/p back to t, 1 to
    common neighbours of t and v, 1/q otherwise, sampled by rejection on
    v's CSR row (vectorized over walks)."""
    wg = walk_graph(g, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cur = torch.from_numpy(np.asarray(starts, np.int64)).to(device)
    prev = cur      # no history on the first hop -> uniform
    walks = [cur]
    for _ in range(walk_length):
        deg = wg.deg[cur]
        r0 = uniform_below(deg, gen)
        rs = [uniform_below(deg, gen) for _ in range(REJECTION_ROUNDS)]
        us = [torch.rand(cur.shape, generator=gen, device=cur.device)
              for _ in range(REJECTION_ROUNDS)]
        prev, cur = cur, _node2vec_step(wg, prev, cur, r0, rs, us, p=p, q=q)
        walks.append(cur)
    return torch.stack(walks, 1).to(torch.int32).cpu().numpy()


def _skipgram_pairs(walks: np.ndarray, window: int) -> tuple[np.ndarray, np.ndarray]:
    """All (center, context) pairs within +-window along each walk."""
    centers, contexts = [], []
    L = walks.shape[1]
    for off in range(1, window + 1):
        if off >= L:
            break
        centers.append(walks[:, :-off].ravel())
        contexts.append(walks[:, off:].ravel())
        centers.append(walks[:, off:].ravel())
        contexts.append(walks[:, :-off].ravel())
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(contexts).astype(np.int32))


def _skipgram_step(u, v, c, o, negs, lr_t: float) -> None:
    """One SGD step of skip-gram with negative sampling on the (B,) centers
    ``c``, contexts ``o`` and (B, K) negatives, in place on ``u`` and
    ``v``; every gradient from the values before the step."""
    uc, vo, vn = u[c], v[o], v[negs]
    s_pos = torch.sigmoid((uc * vo).sum(1))
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", uc, vn))
    g_pos = (s_pos - 1.0)[:, None]             # dL/d(u.v)
    du = g_pos * vo + torch.einsum("bk,bkd->bd", s_neg, vn)
    dvo = g_pos * uc
    dvn = s_neg[..., None] * uc[:, None, :]
    u.index_add_(0, c, du, alpha=-lr_t)
    v.index_add_(0, o, dvo, alpha=-lr_t)
    v.index_add_(0, negs.reshape(-1), dvn.reshape(-1, u.shape[1]),
                 alpha=-lr_t)


def _train_skipgram(nv: int, centers: np.ndarray, contexts: np.ndarray,
                    negatives, *, dim: int, epochs: int, neg: int, lr: float,
                    batch: int, seed: int, device) -> np.ndarray:
    """``train_skipgram`` with the negatives from ``negatives(epoch, step,
    shape)``, an int64 tensor on ``device`` of ids in [0, nv)."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy((rng.random((nv, dim)) - 0.5).astype(np.float32)
                         / dim).to(device)
    v = torch.zeros((nv, dim), dtype=torch.float32, device=device)
    n_pairs = len(centers)
    # scatter-add sums every duplicate index's gradient at full lr, so a
    # batch must not contain many pairs per vertex (tiny graphs would
    # diverge); ~8 appearances per vertex per step is safe
    batch = max(256, min(batch, n_pairs, 8 * nv))
    order = rng.permutation(n_pairs)
    padded = ((n_pairs + batch - 1) // batch) * batch
    centers = torch.from_numpy(np.resize(centers[order], padded).astype(
        np.int64)).to(device)
    contexts = torch.from_numpy(np.resize(contexts[order], padded).astype(
        np.int64)).to(device)
    steps_per_epoch = padded // batch
    t = 0
    for ep in range(epochs):
        for s in range(steps_per_epoch):
            lo = s * batch
            negs = negatives(ep, s, (batch, neg))
            lr_t = lr * max(1e-4, 1 - t / (epochs * steps_per_epoch))
            _skipgram_step(u, v, centers[lo:lo + batch],
                           contexts[lo:lo + batch], negs, lr_t)
            t += 1
    return u.cpu().numpy()


def train_skipgram(nv: int, centers: np.ndarray, contexts: np.ndarray, *,
                   dim: int = 64, epochs: int = 3, neg: int = 5,
                   lr: float = 0.025, batch: int = 65536, seed: int = 0,
                   device="cuda") -> np.ndarray:
    """Skip-gram with negative sampling: loss = -log sig(u_c . v_o) - sum_neg
    log sig(-u_c . v_n), one SGD step per batch. Returns the (nv, dim) input
    embedding matrix. The negatives come from a ``torch.Generator`` seeded
    with ``seed + epoch`` at each epoch's start."""
    gen = None

    def negatives(ep, step, shape):
        nonlocal gen
        if step == 0:
            gen = torch.Generator(device=device).manual_seed(seed + ep)
        return torch.randint(0, nv, shape, generator=gen, device=device)

    return _train_skipgram(nv, centers, contexts, negatives, dim=dim,
                           epochs=epochs, neg=neg, lr=lr, batch=batch,
                           seed=seed, device=device)


def deepwalk(g: CSRGraph, *, dim: int = 64, walks_per_vertex: int = 10,
             walk_length: int = 20, window: int = 5, epochs: int = 3,
             neg: int = 5, lr: float = 0.025, seed: int = 0,
             device="cuda") -> np.ndarray:
    """DeepWalk (Perozzi et al.): uniform walks + skip-gram."""
    starts = np.tile(np.arange(g.nv, dtype=np.int32), walks_per_vertex)
    walks = random_walk(g, starts, walk_length, seed=seed, device=device)
    c, o = _skipgram_pairs(walks, window)
    return train_skipgram(g.nv, c, o, dim=dim, epochs=epochs, neg=neg,
                          lr=lr, seed=seed, device=device)


def node2vec(g: CSRGraph, *, dim: int = 64, walks_per_vertex: int = 10,
             walk_length: int = 20, window: int = 5, p: float = 1.0,
             q: float = 1.0, epochs: int = 3, neg: int = 5,
             lr: float = 0.025, seed: int = 0, device="cuda") -> np.ndarray:
    """node2vec (Grover & Leskovec): p/q-biased walks + skip-gram."""
    starts = np.tile(np.arange(g.nv, dtype=np.int32), walks_per_vertex)
    walks = node2vec_walks(g, starts, walk_length, p=p, q=q, seed=seed,
                           device=device)
    c, o = _skipgram_pairs(walks, window)
    return train_skipgram(g.nv, c, o, dim=dim, epochs=epochs, neg=neg,
                          lr=lr, seed=seed, device=device)
