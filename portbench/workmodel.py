"""The work of one step, counted from the configuration's shapes.

A step is a list of operations, each an SpMM over the graph at a width or a
GEMM (m x k) @ (k x n), in the order the port's layers run them (a frozen
copy of ``nn/layers.py::_aggregate_and_project``: the GEMM first where it
narrows the rows the SpMM reads, y > z) and with the backward that autograd
asks for: the first layer's input needs no gradient, so its adjoint SpMM
and its input GEMM never run. The counts depend on the shapes alone, never
on the layout or the kernels that implement them.

``portbench/kernels/<kernel>.py`` turns the operations into bytes and FLOPs;
``model_flops`` is the step's model FLOPs (GEMMs plus 2 E F for each SpMM,
nothing recomputed), the numerator of ``step.mfu``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str            # "spmm" | "gemm"
    m: int = 0           # gemm: (m x k) @ (k x n)
    k: int = 0
    n: int = 0
    rows: int = 0        # spmm: output rows, input rows, edges, width
    cols: int = 0
    edges: int = 0
    f: int = 0

    @property
    def flops(self) -> int:
        if self.kind == "gemm":
            return 2 * self.m * self.k * self.n
        return 2 * self.edges * self.f


def step_ops(dims: list[int], nv: int, ne: int, *, self_path: bool,
             train: bool) -> list[Op]:
    """The operations of one step of a stack of graph-convolution layers
    with widths ``dims`` on a graph of ``nv`` vertices and ``ne`` edges (as
    aggregated, self-loops included); ``self_path`` adds SAGE's x W_self."""

    def gemm(m, k, n):
        return Op("gemm", m=m, k=k, n=n)

    def spmm(f):
        return Op("spmm", rows=nv, cols=nv, edges=ne, f=f)

    ops = []
    for l in range(len(dims) - 1):
        y, z = dims[l], dims[l + 1]
        gemm_first = y > z
        ops += [gemm(nv, y, z), spmm(z)] if gemm_first else [spmm(y), gemm(nv, y, z)]
        if self_path:
            ops.append(gemm(nv, y, z))
    if not train:
        return ops
    for l in reversed(range(len(dims) - 1)):
        y, z = dims[l], dims[l + 1]
        needs_dx = l > 0
        if y > z:
            ops.append(spmm(z))                 # the adjoint of A (x W)
            ops.append(gemm(y, nv, z))          # dW
            if needs_dx:
                ops.append(gemm(nv, z, y))      # dx
        else:
            ops.append(gemm(y, nv, z))          # dW of (A x) W
            if needs_dx:
                ops += [gemm(nv, z, y), spmm(y)]
        if self_path:
            ops.append(gemm(y, nv, z))
            if needs_dx:
                ops.append(gemm(nv, z, y))
    return ops


def model_flops(ops: list[Op]) -> int:
    return sum(op.flops for op in ops)
