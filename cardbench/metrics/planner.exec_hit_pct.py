"""planner.exec_hit_pct: the executor cache's hit share in the window
(``Planner._build_runner``): the program's ``exec_cache_hits`` over
those hits and its ``exec_cache_packs`` (the misses, packed), from the
registry before and after the window; ``None`` where neither moved."""


def _moved(obs, key: str) -> float:
    return obs.counters_after.get(key, 0) - obs.counters_before.get(key, 0)


def read(obs):
    hits = _moved(obs, "exec_cache_hits")
    packs = _moved(obs, "exec_cache_packs")
    if hits + packs <= 0:
        return None
    return 100.0 * hits / (hits + packs)
