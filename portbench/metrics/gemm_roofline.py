"""The GEMMs' share of their roofline, in %: the least time of a step's
GEMMs (each the larger of its bytes over the memory rate and its FLOPs over
the float32 rate, TF32 off) over the GEMM kernels' summed device time."""


def read(t):
    return t.roofline_share("gemm")
