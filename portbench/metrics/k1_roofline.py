"""K1's share of its roofline, in %: the least time of a step's SpMMs,
forward and adjoint (each the larger of its bytes over the memory rate and
2 E F over the float32 rate, counted from the shapes), over K1's summed
device time."""


def read(t):
    return t.roofline_share("k1")
