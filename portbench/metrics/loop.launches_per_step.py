"""Device operations (kernels, copies, fills) the host enqueued per traced
step: an exact count while the steps repeat. A launch taken off the step,
or a sync put into it, shows here first."""


def read(t):
    return len(t.device_ops) / t.steps if t.device_ops else None
