"""K1's device milliseconds per traced step, forward and adjoint."""


def read(t):
    s = t.kernel_s("k1")
    return 1e3 * s / t.steps if s else None
