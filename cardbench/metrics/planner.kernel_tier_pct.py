"""planner.kernel_tier_pct: the share of the window's products that ran
on the kernel tier (``Planner._execute_impl``): the program's
``kernel_tier_products`` (plans of scheme ``pallas``) over those and its
``gather_tier_products`` (the four gather-tier schemes), from the
registry before and after the window; ``None`` where neither moved, as
in a program without the two counters."""


def _moved(obs, key: str) -> float:
    return obs.counters_after.get(key, 0) - obs.counters_before.get(key, 0)


def read(obs):
    kernel = _moved(obs, "kernel_tier_products")
    gather = _moved(obs, "gather_tier_products")
    if kernel + gather <= 0:
        return None
    return 100.0 * kernel / (kernel + gather)
