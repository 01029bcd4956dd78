"""Device milliseconds per traced step that the program's ``gab.backward``
span launched, on any thread: the GEMMs' gradients, K1's adjoint (also in
``k1.adjoint_ms_per_step``), the activations' and dropout's backward
(``portbench/spans.py``)."""

from portbench import spans


def read(t):
    return spans.phase_ms_per_step(t, "gab.backward")
