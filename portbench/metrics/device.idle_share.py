"""The share of the traced window, in %, in which no operation ran on the
device: what the host's dispatch and syncs cost the step."""


def read(t):
    if not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
