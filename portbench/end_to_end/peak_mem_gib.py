"""The caching allocator's peak of device memory over the set-up (after the
graph is made or loaded) and the window, in GiB."""


def read(w):
    return w.memory_peak_bytes / 2**30
