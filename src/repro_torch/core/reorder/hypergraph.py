"""Hypergraph Partitioning (PaToH-style, column-net model) [13].

Rows of A are hypergraph vertices; each column is a net connecting the rows
with a nonzero in it. Recursive bisection minimizes the *cut-net* metric with
FM-style refinement using net pin counts (a net is cut iff it has pins on
both sides). Rows are then emitted in leaf-partition order.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import HostCSR

__all__ = ["hypergraph_partition"]


def _hg_bisect(indptr, indices, col_indptr, col_rows, verts: np.ndarray,
               seed: int, fm_passes: int = 3) -> np.ndarray:
    """Bisect ``verts`` (row ids) minimizing cut nets. Returns side per vert."""
    rng = np.random.default_rng(seed)
    nv = verts.size
    side = np.zeros(nv, dtype=np.int8)
    # initial split: sort rows by their mean column id (cheap geometric cue)
    mean_col = np.empty(nv, dtype=np.float64)
    for i, v in enumerate(verts):
        cols = indices[indptr[v]: indptr[v + 1]]
        mean_col[i] = cols.mean() if cols.size else rng.random()
    order = np.argsort(mean_col, kind="stable")
    side[order[nv // 2:]] = 1

    in_set = np.full(col_indptr.shape[0] - 1 + 1, -1, dtype=np.int64)
    vert_pos = {int(v): i for i, v in enumerate(verts)}

    # pin counts per net restricted to `verts`
    nets = np.unique(np.concatenate(
        [indices[indptr[v]: indptr[v + 1]] for v in verts]
        or [np.empty(0, np.int32)]))
    pins0 = {}
    pins1 = {}
    for c in nets:
        rows = col_rows[col_indptr[c]: col_indptr[c + 1]]
        local = [vert_pos[int(r)] for r in rows if int(r) in vert_pos]
        s = side[local]
        pins0[int(c)] = int((s == 0).sum())
        pins1[int(c)] = int((s == 1).sum())

    half = nv // 2
    counts = np.bincount(side, minlength=2)
    for _ in range(fm_passes):
        moved = 0
        for i in rng.permutation(nv):
            v = int(verts[i])
            s = int(side[i])
            cols = indices[indptr[v]: indptr[v + 1]]
            gain = 0
            for c in cols:
                c = int(c)
                mine = pins0[c] if s == 0 else pins1[c]
                theirs = pins1[c] if s == 0 else pins0[c]
                if mine == 1 and theirs > 0:
                    gain += 1       # moving uncuts this net
                elif theirs == 0 and mine > 1:
                    gain -= 1       # moving cuts this net
            if gain > 0 and counts[1 - s] < half * 1.1 + 1:
                side[i] = 1 - s
                counts[s] -= 1
                counts[1 - s] += 1
                for c in cols:
                    c = int(c)
                    if s == 0:
                        pins0[c] -= 1
                        pins1[c] += 1
                    else:
                        pins1[c] -= 1
                        pins0[c] += 1
                moved += 1
        if moved == 0:
            break
    return side


def _hp_recurse(indptr, indices, col_indptr, col_rows, verts, seed,
                leaf, out) -> None:
    if verts.size <= leaf:
        out.append(verts)
        return
    side = _hg_bisect(indptr, indices, col_indptr, col_rows, verts, seed)
    left, right = verts[side == 0], verts[side == 1]
    if left.size == 0 or right.size == 0:
        out.append(verts)
        return
    _hp_recurse(indptr, indices, col_indptr, col_rows, left,
                seed * 2 + 1, leaf, out)
    _hp_recurse(indptr, indices, col_indptr, col_rows, right,
                seed * 2 + 2, leaf, out)


def hypergraph_partition(a: HostCSR, seed: int = 0,
                         leaf: int | None = None) -> np.ndarray:
    at = a.transpose()
    if leaf is None:
        leaf = max(128, a.nrows // 64)
    out: list[np.ndarray] = []
    _hp_recurse(a.indptr, a.indices, at.indptr, at.indices,
                np.arange(a.nrows, dtype=np.int64), seed + 1, leaf, out)
    perm = np.concatenate(out)
    assert np.unique(perm).size == a.nrows
    return perm
