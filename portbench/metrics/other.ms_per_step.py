"""Device milliseconds per traced step of every operation that is neither
K1 nor a GEMM: dropout, activations, the loss, Adam, fills and copies."""


def read(t):
    if not t.device_ops:
        return None
    return 1e3 * (t.device_s() - t.kernel_s("k1") - t.kernel_s("gemm")) / t.steps
