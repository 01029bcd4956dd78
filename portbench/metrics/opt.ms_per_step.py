"""Device milliseconds per traced step that the program's ``gab.optimizer``
span launched: the optimizer's step over every parameter
(``portbench/spans.py``)."""

from portbench import spans


def read(t):
    return spans.phase_ms_per_step(t, "gab.optimizer")
