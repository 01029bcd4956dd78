"""GiB the window's steps allocate on top of what the set-up left held: the
caching allocator's peak over the window less what was allocated when it
opened."""


def read(t):
    m = t.memory
    if m.get("window_peak_bytes") is None:
        return None
    return (m["window_peak_bytes"] - m["held_bytes"]) / 2**30
