"""Row-reordering registry — the 10 algorithms of the paper's study (Table 1).

Every algorithm maps ``HostCSR -> perm`` with ``perm[new_row] = old_row``.
For the A² workload the permutation is applied *symmetrically* (PAPᵀ), as the
paper does for square matrices, so that reordering changes locality but not
the multiplication's intrinsic structure.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.core.reorder.basic import (degree_order, gray_order, original,
                                      random_shuffle)
from repro_torch.core.reorder.rcm import rcm
from repro_torch.core.reorder.amd import amd
from repro_torch.core.reorder.dissection import graph_partition, nested_dissection
from repro_torch.core.reorder.hypergraph import hypergraph_partition
from repro_torch.core.reorder.community import rabbit_order, slashburn

REORDERINGS: dict[str, Callable[..., np.ndarray]] = {
    "original": original,
    "random": random_shuffle,
    "rcm": rcm,
    "amd": amd,
    "nd": nested_dissection,
    "gp": graph_partition,
    "hp": hypergraph_partition,
    "gray": gray_order,
    "rabbit": rabbit_order,
    "degree": degree_order,
    "slashburn": slashburn,
}

__all__ = ["REORDERINGS", "reorder", "original", "random_shuffle", "rcm",
           "amd", "nested_dissection", "graph_partition",
           "hypergraph_partition", "gray_order", "rabbit_order",
           "degree_order", "slashburn"]


def reorder(a: HostCSR, algo: str, *, seed: int = 0,
            symmetric: bool = True) -> tuple[HostCSR, np.ndarray]:
    """Apply a named reordering; returns (reordered matrix, permutation)."""
    if algo not in REORDERINGS:
        raise KeyError(f"unknown reordering '{algo}' "
                       f"(have {sorted(REORDERINGS)})")
    perm = REORDERINGS[algo](a, seed=seed)
    if symmetric and a.nrows == a.ncols:
        return a.permute_symmetric(perm), perm
    return a.permute_rows(perm), perm
