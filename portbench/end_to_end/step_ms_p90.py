"""The 90th percentile (nearest rank) over all of the window's consecutive
groups of ``tail_group_steps`` steps (the mix's) of the group's time per
step, in ms. A group spans 250 ms or more of the host's clock, whose
readings are good to about half a millisecond; a stall, a sync that creeps
in or a slow step every k lengthens its group."""

import math


def read(w):
    k = w.group_steps
    times = sorted(1e3 * (w.bounds[i + k] - w.bounds[i]) / k
                   for i in range(0, len(w.bounds) - k, k))
    return times[math.ceil(0.9 * len(times)) - 1]
