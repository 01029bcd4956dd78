"""Milliseconds per step: the whole window's time over the steps it
completed, the steps back to back, each ended when its result reached the
host."""


def read(w):
    return 1e3 * (w.bounds[-1] - w.bounds[0]) / (len(w.bounds) - 1)
