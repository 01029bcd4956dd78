"""The dense GEMMs of the layers (cuBLAS or CUTLASS SGEMMs, TF32 off).

The least a GEMM (m x k) @ (k x n) needs of memory: both operands read once
and the product written once (4 bytes a value); its operations 2 m k n.
PATTERN matches the library's GEMM kernels and its split-K reductions by
name.
"""

PATTERN = r"(?i)gemm|gemv|splitkreduce"


def work(op):
    """(bytes, FLOPs) of one operation of the step, None if not a GEMM."""
    if op.kind != "gemm":
        return None
    return 4 * (op.m * op.k + op.k * op.n + op.m * op.n), 2 * op.m * op.k * op.n
