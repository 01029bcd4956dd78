"""K1's device milliseconds per traced step inside the program's
``gab.spmm.adjoint`` spans: the SpMMs of the backward, on the packed
transpose view. K1's forward is ``k1.ms_per_step`` less this
(``portbench/spans.py``)."""

from portbench import spans


def read(t):
    return spans.ms_per_step(t, "gab.spmm.adjoint",
                             pattern=t.kernels["k1"].PATTERN)
