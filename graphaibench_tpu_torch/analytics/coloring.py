"""Greedy vertex coloring: parallel first-fit + conflict resolution.

Counterpart of ``graphaibench_tpu/analytics/coloring.py``, the reference's
scheme (src/coloring/omp_base.cc:6-41): every (conflicted) vertex takes the
smallest colour absent from its neighbourhood, edges whose endpoints collide
are found, and the lower-id endpoint runs again until no conflict is left.
The first-fit step is the kernel K14 on a CUDA graph (``ops/first_fit.py``),
which builds no (nv, max_colors) matrix; the conflict step is plain PyTorch
over the (ne,) edge arrays. The rounds are a Python loop that reads one flag
a round and stops, as JAX's ``while_loop``, when no vertex is active or
after ``max_colors + 2`` rounds.
"""

from __future__ import annotations

import torch

from graphaibench_tpu_torch.ops.device_graph import DeviceGraph
from graphaibench_tpu_torch.ops.first_fit import first_fit


def color(g: DeviceGraph, *, max_colors: int | None = None,
          return_rounds: bool = False):
    """(nv,) int32 colours of ``g`` (on its device); with ``return_rounds``
    also the number of rounds, each one first-fit step."""
    nv = g.nv
    dev = g.col_idx.device
    src, dst = g.edge_src.long(), g.col_idx.long()
    if max_colors is None:
        max_colors = int(g.deg.max()) + 2 if nv else 1
    colors = torch.zeros(nv, dtype=torch.int32, device=dev)
    active = torch.ones(nv, dtype=torch.bool, device=dev)
    it = 0
    while nv and bool(active.any()) and it < max_colors + 2:
        colors = first_fit(g, colors, active, max_colors)
        conflict = (colors[src] == colors[dst]) & (src != dst)
        # the smaller endpoint takes a colour again (the reference's
        # deterministic tie-break)
        loser = torch.minimum(src, dst)[conflict]
        active = torch.zeros(nv, dtype=torch.bool, device=dev)
        active[loser] = True
        it += 1
    return (colors, it) if return_rounds else colors
