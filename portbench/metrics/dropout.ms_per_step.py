"""Device milliseconds per traced step that the program's ``gab.dropout``
spans launched: each mask's draw and its use in the forward; 0 in a step
that draws no mask (SAGE). Its backward counts in ``bwd.ms_per_step``
(``portbench/spans.py``)."""

from portbench import spans


def read(t):
    return spans.phase_ms_per_step(t, "gab.dropout")
