"""device.idle_pct: the share of the profiled stretch in which no
kernel, copy or set ran on the card."""

from cardbench import profiling


def read(obs):
    p = obs.profile
    if p is None or p.window_s <= 0 or not p.events:
        return None
    return 100.0 * (1.0 - profiling.busy_s(p) / p.window_s)
