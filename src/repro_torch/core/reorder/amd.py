"""Approximate Minimum Degree ordering [3, 19].

A faithful-in-spirit, simplified AMD: eliminate the vertex of (approximately)
minimum degree; its neighbors form a clique in the elimination graph. To keep
preprocessing near O(nnz·log n) — the paper's point is that AMD is a *cheap*
fill-reducing ordering — fill edges are tracked through *element absorption*
(quotient-graph style): eliminated vertices become elements, and a vertex's
approximate degree is |adjacent variables| + Σ|element boundaries| (Amestoy's
upper bound), without forming explicit fill edges.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.core.reorder.graph import build_adjacency

__all__ = ["amd"]


def amd(a: HostCSR, seed: int = 0, dense_cap: int = 10_000) -> np.ndarray:
    adj = build_adjacency(a)
    n = adj.n
    # variable adjacency (sets of variables) + element lists per variable
    var_adj: list[set[int]] = [set(map(int, adj.neighbors(v)))
                               for v in range(n)]
    var_elems: list[set[int]] = [set() for _ in range(n)]
    elem_bound: dict[int, set[int]] = {}      # element -> boundary variables
    eliminated = np.zeros(n, dtype=bool)
    approx_deg = adj.degrees().astype(np.int64)

    heap: list[tuple[int, int]] = [(int(approx_deg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    order = np.empty(n, dtype=np.int64)
    pos = 0

    # very dense rows are deferred to the end (standard AMD "dense" handling)
    dense = approx_deg > min(dense_cap, max(16, int(np.sqrt(n) * 8)))

    while heap and pos < n:
        d, p = heapq.heappop(heap)
        if eliminated[p] or dense[p]:
            continue
        if d != approx_deg[p]:
            heapq.heappush(heap, (int(approx_deg[p]), p))
            continue
        # eliminate p → becomes element p
        eliminated[p] = True
        order[pos] = p
        pos += 1
        # boundary: live variable neighbors + boundaries of absorbed elements
        bound = {v for v in var_adj[p] if not eliminated[v]}
        for e in var_elems[p]:
            if e in elem_bound:
                bound |= {v for v in elem_bound[e] if not eliminated[v]}
                del elem_bound[e]  # absorption
        bound.discard(p)
        elem_bound[p] = bound
        for v in bound:
            var_adj[v].discard(p)
            var_elems[v].add(p)
            var_elems[v] = {e for e in var_elems[v] if e in elem_bound}
            live = sum(1 for u in var_adj[v] if not eliminated[u])
            elem_sz = sum(len(elem_bound[e]) - 1 for e in var_elems[v])
            nd = min(n - pos - 1, live + elem_sz)
            approx_deg[v] = max(nd, 0)
            heapq.heappush(heap, (int(approx_deg[v]), v))

    for v in np.flatnonzero(dense):
        if not eliminated[v]:
            order[pos] = v
            pos += 1
    assert pos == n, "AMD failed to order every vertex"
    perm = order
    if a.nrows > n:
        perm = np.concatenate([perm, np.arange(n, a.nrows, dtype=np.int64)])
    return perm
