"""planner.slab_fill_pct: the share of C's live CompactedC slabs that
holds its entries, in the window's sparse-C products
(``Planner._chain_hop_sparse``): 4 bytes a float32 entry times the
program's ``sparse_c_entries`` over its ``sparse_c_slab_bytes``, from
the registry before and after the window; ``None`` where no slab byte
moved, as in a program without the two counters."""


def _moved(obs, key: str) -> float:
    return obs.counters_after.get(key, 0) - obs.counters_before.get(key, 0)


def read(obs):
    slab_bytes = _moved(obs, "sparse_c_slab_bytes")
    if slab_bytes <= 0:
        return None
    return 100.0 * 4 * _moved(obs, "sparse_c_entries") / slab_bytes
