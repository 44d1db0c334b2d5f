"""Nested Dissection [18, 24] and Graph Partitioning (METIS-style) [33].

Both are built on a recursive edge-separator bisection: a BFS level structure
from a pseudo-peripheral vertex splits the component at the median level, and
a few Fiduccia–Mattheyses-style refinement passes reduce the edge cut.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.core.reorder.graph import (Adjacency, bfs_levels, build_adjacency,
                                      pseudo_peripheral)

__all__ = ["nested_dissection", "graph_partition"]


def _bisect(adj: Adjacency, verts: np.ndarray, seed: int,
            fm_passes: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Split ``verts`` into two balanced halves with a small edge cut.

    Returns (side ∈ {0,1} per vertex of ``verts``, positions aligned with
    ``verts``).
    """
    n = adj.n
    mask = np.zeros(n, dtype=bool)
    mask[verts] = True
    rng = np.random.default_rng(seed)
    start = int(verts[rng.integers(verts.size)])
    src, levels = pseudo_peripheral(adj, start, mask)
    lv = levels[verts]
    reached = lv >= 0
    if not reached.any():
        side = np.zeros(verts.size, dtype=np.int8)
        side[verts.size // 2:] = 1
        return side, verts
    # median level split over reached vertices; unreached go to smaller side
    med = np.median(lv[reached])
    side = (lv > med).astype(np.int8)
    side[~reached] = 1 if side[reached].mean() < 0.5 else 0
    # FM-style refinement: move boundary vertices with positive gain
    side_full = np.full(n, -1, dtype=np.int8)
    side_full[verts] = side
    half = verts.size // 2
    for _ in range(fm_passes):
        moved = 0
        counts = np.bincount(side_full[verts], minlength=2)
        for i, v in enumerate(verts):
            nbrs = adj.neighbors(int(v))
            nbrs = nbrs[mask[nbrs]]
            if nbrs.size == 0:
                continue
            s = side_full[v]
            same = int((side_full[nbrs] == s).sum())
            gain = (nbrs.size - same) - same
            # balance guard: keep halves within 10%
            if gain > 0 and counts[1 - s] < half * 1.1:
                side_full[v] = 1 - s
                counts[s] -= 1
                counts[1 - s] += 1
                moved += 1
        if moved == 0:
            break
    return side_full[verts], verts


def _vertex_separator(adj: Adjacency, verts: np.ndarray,
                      side: np.ndarray) -> np.ndarray:
    """Boundary vertices of side-0 adjacent to side-1 (a vertex separator)."""
    n = adj.n
    side_full = np.full(n, -1, dtype=np.int8)
    side_full[verts] = side
    sep = []
    for v in verts[side == 0]:
        nbrs = adj.neighbors(int(v))
        if (side_full[nbrs] == 1).any():
            sep.append(int(v))
    return np.asarray(sep, dtype=np.int64)


def _nd_recurse(adj: Adjacency, verts: np.ndarray, seed: int,
                leaf: int, out: list[np.ndarray]) -> None:
    if verts.size <= leaf:
        deg = adj.degrees()[verts]
        out.append(verts[np.argsort(deg, kind="stable")])
        return
    side, verts = _bisect(adj, verts, seed)
    sep = _vertex_separator(adj, verts, side)
    in_sep = np.zeros(adj.n, dtype=bool)
    in_sep[sep] = True
    left = verts[(side == 0) & ~in_sep[verts]]
    right = verts[(side == 1) & ~in_sep[verts]]
    if left.size == 0 or right.size == 0:   # degenerate split: stop here
        out.append(verts)
        return
    _nd_recurse(adj, left, seed * 2 + 1, leaf, out)
    _nd_recurse(adj, right, seed * 2 + 2, leaf, out)
    out.append(sep)  # separators ordered last (fill-reducing convention)


def nested_dissection(a: HostCSR, seed: int = 0,
                      leaf: int = 64) -> np.ndarray:
    adj = build_adjacency(a)
    parts: list[np.ndarray] = []
    _nd_recurse(adj, np.arange(adj.n, dtype=np.int64), seed + 1, leaf, parts)
    perm = np.concatenate(parts) if parts else np.empty(0, np.int64)
    assert np.unique(perm).size == adj.n
    if a.nrows > adj.n:
        perm = np.concatenate([perm, np.arange(adj.n, a.nrows,
                                               dtype=np.int64)])
    return perm


def _gp_recurse(adj: Adjacency, verts: np.ndarray, seed: int,
                leaf: int, out: list[np.ndarray]) -> None:
    if verts.size <= leaf:
        out.append(verts)
        return
    side, verts = _bisect(adj, verts, seed)
    left, right = verts[side == 0], verts[side == 1]
    if left.size == 0 or right.size == 0:
        out.append(verts)
        return
    _gp_recurse(adj, left, seed * 2 + 1, leaf, out)
    _gp_recurse(adj, right, seed * 2 + 2, leaf, out)


def graph_partition(a: HostCSR, seed: int = 0,
                    leaf: int | None = None) -> np.ndarray:
    """METIS-style edge-cut recursive bisection; rows ordered by partition.

    Unlike ND there is no separator — every vertex lands in a leaf partition
    and partitions are emitted contiguously (the paper reorders rows by METIS
    partition assignment).
    """
    adj = build_adjacency(a)
    if leaf is None:
        leaf = max(128, adj.n // 64)
    parts: list[np.ndarray] = []
    _gp_recurse(adj, np.arange(adj.n, dtype=np.int64), seed + 1, leaf, parts)
    perm = np.concatenate(parts) if parts else np.empty(0, np.int64)
    assert np.unique(perm).size == adj.n
    if a.nrows > adj.n:
        perm = np.concatenate([perm, np.arange(adj.n, a.nrows,
                                               dtype=np.int64)])
    return perm
