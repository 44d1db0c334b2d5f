"""Reverse Cuthill–McKee bandwidth-reducing ordering [15, 38]."""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.core.reorder.graph import build_adjacency, pseudo_peripheral

__all__ = ["rcm"]


def rcm(a: HostCSR, seed: int = 0) -> np.ndarray:
    adj = build_adjacency(a)
    n = adj.n
    deg = adj.degrees()
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # process components in order of their lowest-degree vertex
    seeds = np.argsort(deg, kind="stable")
    for s in seeds:
        if visited[s]:
            continue
        start, _ = pseudo_peripheral(adj, int(s), ~visited)
        visited[start] = True
        order[pos] = start
        pos += 1
        head = pos - 1
        while head < pos:
            v = order[head]
            head += 1
            nbrs = adj.neighbors(int(v))
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos: pos + nbrs.size] = nbrs
                pos += nbrs.size
    perm = order[::-1].copy()  # the "reverse" in RCM
    if a.nrows > n:  # rectangular tail rows keep original order
        perm = np.concatenate([perm, np.arange(n, a.nrows, dtype=np.int64)])
    return perm
