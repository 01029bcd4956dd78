"""Linear assignment (Hungarian algorithm).

The port's own copy of ``graphaibench_tpu/analytics/assignment.py``: host
numpy, bit-equal to it (``tests/test_torch_p15b.py``).

The reference's src/linear_assignment is README-only ("Hungarian"). Real
O(n^3) shortest-augmenting-path implementation (Jonker-Volgenant style
potentials) over a dense cost matrix."""

from __future__ import annotations

import numpy as np


def hungarian(cost: np.ndarray) -> tuple[np.ndarray, float]:
    """Minimum-cost perfect matching of a square cost matrix.
    Returns (col_of_row, total_cost)."""
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    assert cost.shape == (n, n)
    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=np.int64)        # p[j] = row matched to col j
    way = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = 0
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.zeros(n, dtype=np.int64)
    for j in range(1, n + 1):
        if p[j] > 0:
            col_of_row[p[j] - 1] = j - 1
    total = float(cost[np.arange(n), col_of_row].sum())
    return col_of_row, total


def assignment_oracle(cost: np.ndarray) -> float:
    """Brute-force optimum for small n (verifier)."""
    import itertools

    n = cost.shape[0]
    best = np.inf
    for perm in itertools.permutations(range(n)):
        best = min(best, float(cost[np.arange(n), perm].sum()))
    return best
