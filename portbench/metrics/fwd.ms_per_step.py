"""Device milliseconds per traced step that the program's ``gab.forward``
span launched: the layers' GEMMs, K1's forward SpMMs, the activations and
the loss. Dropout's draws and masks count in ``dropout.ms_per_step``
(``portbench/spans.py``: the innermost phase wins)."""

from portbench import spans


def read(t):
    return spans.phase_ms_per_step(t, "gab.forward")
