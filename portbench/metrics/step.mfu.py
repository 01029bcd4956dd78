"""The whole step's share of the card's float32 peak, in %: the step's model
FLOPs (GEMMs plus 2 E F for each SpMM, nothing recomputed) over the traced
step time (the traced window over its steps) times the peak. It bounds
every kernel's gain: a kernel taken off the path leaves its roofline silent
and this one still counts."""


def read(t):
    if t.peaks is None or not t.device_ops:
        return None
    return 100.0 * t.model_flops * t.steps / (t.window_s * t.peaks["f32_flops"])
