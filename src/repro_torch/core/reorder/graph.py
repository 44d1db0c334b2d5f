"""Shared graph utilities for the reordering algorithms.

All reorderings operate on the *structure* of the (possibly rectangular)
matrix; graph-based methods use the symmetrized pattern of the square part,
``G = pattern(A) ∪ pattern(Aᵀ)`` with self-loops removed, in adjacency-CSR
form (int32 indptr/indices, numpy).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import HostCSR

__all__ = ["Adjacency", "build_adjacency", "bfs_levels",
           "pseudo_peripheral", "connected_components"]


class Adjacency:
    __slots__ = ("indptr", "indices", "n")

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.indptr = indptr
        self.indices = indices
        self.n = indptr.shape[0] - 1

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def build_adjacency(a: HostCSR) -> Adjacency:
    """Symmetrized pattern graph of the square part of ``a``."""
    n = min(a.nrows, a.ncols)
    row_ids = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    cols = a.indices.astype(np.int64)
    keep = (row_ids < n) & (cols < n) & (row_ids != cols)
    r, c = row_ids[keep], cols[keep]
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    # dedupe
    key = rr * n + cc
    uniq = np.unique(key)
    rr = (uniq // n).astype(np.int64)
    cc = (uniq % n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rr + 1, 1)
    np.cumsum(indptr, out=indptr)
    return Adjacency(indptr, cc.astype(np.int32))


def bfs_levels(adj: Adjacency, start: int,
               mask: np.ndarray | None = None) -> np.ndarray:
    """Level of each vertex from ``start`` (-1 unreachable / masked out)."""
    level = np.full(adj.n, -1, dtype=np.int64)
    if mask is not None and not mask[start]:
        return level
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        nbrs = np.concatenate([adj.neighbors(v) for v in frontier]) \
            if frontier.size else np.empty(0, np.int32)
        if nbrs.size == 0:
            break
        nbrs = np.unique(nbrs).astype(np.int64)
        new = nbrs[level[nbrs] == -1]
        if mask is not None:
            new = new[mask[new]]
        level[new] = d
        frontier = new
    return level


def pseudo_peripheral(adj: Adjacency, start: int,
                      mask: np.ndarray | None = None,
                      max_iter: int = 8) -> tuple[int, np.ndarray]:
    """George–Liu pseudo-peripheral node finder. Returns (node, levels)."""
    v = start
    levels = bfs_levels(adj, v, mask)
    ecc = levels.max()
    for _ in range(max_iter):
        last = np.flatnonzero(levels == ecc)
        if last.size == 0:
            break
        deg = adj.degrees()[last]
        cand = int(last[np.argmin(deg)])
        lv = bfs_levels(adj, cand, mask)
        if lv.max() > ecc:
            v, levels, ecc = cand, lv, lv.max()
        else:
            v, levels = cand, lv
            break
    return v, levels


def connected_components(adj: Adjacency,
                         mask: np.ndarray | None = None) -> np.ndarray:
    """Component id per vertex (-1 for masked-out vertices)."""
    comp = np.full(adj.n, -1, dtype=np.int64)
    cid = 0
    active = np.ones(adj.n, bool) if mask is None else mask.copy()
    for s in range(adj.n):
        if not active[s] or comp[s] != -1:
            continue
        lv = bfs_levels(adj, s, active)
        comp[lv >= 0] = cid
        cid += 1
    return comp
