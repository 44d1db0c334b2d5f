"""The paper's three clustering strategies (§3.2–§3.3).

All three return *cluster boundaries over consecutive rows* of a (possibly
reordered) matrix plus, for hierarchical clustering, the row permutation that
makes its clusters consecutive. This uniform output feeds directly into
``formats.csr_cluster_from_host`` / ``formats.bcc_from_host``.

* :func:`fixed_length_clusters` — every R consecutive rows (paper §3.2).
* :func:`variable_length_clusters` — Alg. 2: greedy scan, join the open
  cluster iff Jaccard(representative, row) ≥ jacc_th, cap at max_cluster_th.
  The scan is *batched*: a representative can live at most max_cluster_th−1
  rows behind any member, so all Jaccard scores the scan can ever consult
  are ``J(i−d, i)`` for d < max_cluster_th — computed in max_cluster_th−1
  vectorized sorted-merge passes (:func:`pairwise_jaccard_offset`); the
  boundary sequence is then a successor chase with O(1) work per cluster.
* :func:`hierarchical_clusters` — Alg. 3: candidate pairs from binarized
  SpGEMM(A·Aᵀ) top-K (the vectorized COO-join generator), max-heap +
  union–find merging with lazy rescoring, and a fully vectorized final
  layout (pointer-jumping root resolution + one lexsort).

The original per-row scan is retained as
:func:`variable_length_clusters_reference` for the equivalence property
tests and the preprocessing benchmark.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.core.segment import boundary_mask
from repro_torch.core.similarity import jaccard_pairs_topk, pairwise_jaccard_offset

__all__ = ["Clustering", "fixed_length_clusters", "variable_length_clusters",
           "variable_length_clusters_reference", "hierarchical_clusters",
           "DEFAULT_JACC_TH", "DEFAULT_MAX_CLUSTER"]

DEFAULT_JACC_TH = 0.3      # paper §3.2
DEFAULT_MAX_CLUSTER = 8    # paper §3.2


@dataclasses.dataclass(frozen=True)
class Clustering:
    """Cluster boundaries over consecutive rows of ``matrix`` (which may be a
    reordered view of the input; ``perm`` maps new→old rows)."""

    boundaries: np.ndarray          # (nclusters,) start rows, sorted, [0]==0
    perm: np.ndarray                # (nrows,) new→old
    max_cluster: int

    @property
    def nclusters(self) -> int:
        return int(self.boundaries.shape[0])

    def sizes(self, nrows: int) -> np.ndarray:
        b = np.concatenate([self.boundaries, [nrows]])
        return np.diff(b)


def fixed_length_clusters(a: HostCSR, length: int = DEFAULT_MAX_CLUSTER
                          ) -> Clustering:
    if length < 1:
        raise ValueError("cluster length must be >= 1")
    return Clustering(
        boundaries=np.arange(0, a.nrows, length, dtype=np.int64),
        perm=np.arange(a.nrows, dtype=np.int64),
        max_cluster=length)


def variable_length_clusters(a: HostCSR,
                             jacc_th: float = DEFAULT_JACC_TH,
                             max_cluster_th: int = DEFAULT_MAX_CLUSTER
                             ) -> Clustering:
    """Alg. 2 — representative-row greedy scan, no reordering (batched).

    A cluster opened at row r absorbs rows r+1, r+2, … while
    ``J(r, i) ≥ jacc_th`` and ``i − r < max_cluster_th``; the next boundary
    after r is therefore ``r + min(first d with J(r, r+d) < jacc_th,
    max_cluster_th)``. All J(i−d, i) are precomputed vectorized (one
    sorted-merge pass per offset d), the successor of *every* possible
    start row is derived in one argmax, and the scan reduces to chasing
    successors — O(1) Python work per emitted cluster, zero per-row
    similarity loops. Boundary-for-boundary identical to
    :func:`variable_length_clusters_reference`.
    """
    n = a.nrows
    d_max = max_cluster_th
    if n <= 1 or d_max == 1:
        return variable_length_clusters_reference(a, jacc_th, max_cluster_th)
    # fail[d-1, r] — True iff row r+d does NOT join a cluster whose
    # representative is row r (score below threshold at distance d)
    fail = np.zeros((d_max - 1, n), dtype=bool)
    for d in range(1, min(d_max, n)):
        jd = pairwise_jaccard_offset(a, d)            # jd[r] = J(r, r+d)
        fail[d - 1, : n - d] = jd < jacc_th
    # successor[r] = next cluster boundary if a cluster starts at row r
    any_fail = fail.any(axis=0)
    first_fail = np.where(any_fail, fail.argmax(axis=0) + 1, d_max)
    successor = np.arange(n, dtype=np.int64) + first_fail
    bounds = [0]
    r = 0
    while successor[r] < n:                           # one step per cluster
        r = int(successor[r])
        bounds.append(r)
    return Clustering(boundaries=np.asarray(bounds, dtype=np.int64),
                      perm=np.arange(n, dtype=np.int64),
                      max_cluster=max_cluster_th)


def variable_length_clusters_reference(a: HostCSR,
                                       jacc_th: float = DEFAULT_JACC_TH,
                                       max_cluster_th: int =
                                       DEFAULT_MAX_CLUSTER) -> Clustering:
    """Loop reference for Alg. 2 (property-test oracle)."""
    bounds = [0]
    rep = 0
    size = 1
    for i in range(1, a.nrows):
        score = a.jaccard(rep, i)
        if score < jacc_th or size == max_cluster_th:
            bounds.append(i)
            rep, size = i, 1
        else:
            size += 1
    return Clustering(boundaries=np.asarray(bounds, dtype=np.int64),
                      perm=np.arange(a.nrows, dtype=np.int64),
                      max_cluster=max_cluster_th)


class _UnionFind:
    __slots__ = ("parent", "size")

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = int(self.parent[root])
        while self.parent[x] != root:       # path compression
            self.parent[x], x = root, int(self.parent[x])
        return root

    def union(self, x: int, y: int) -> int:
        rx, ry = self.find(x), self.find(y)
        if rx == ry:
            return rx
        if self.size[rx] < self.size[ry]:
            rx, ry = ry, rx
        self.parent[ry] = rx
        self.size[rx] += self.size[ry]
        return rx

    def roots(self) -> np.ndarray:
        """Root of every element at once — vectorized pointer jumping."""
        parent = self.parent
        while True:
            grand = parent[parent]
            if np.array_equal(grand, parent):
                return parent
            parent = grand


def hierarchical_clusters(a: HostCSR,
                          jacc_th: float = DEFAULT_JACC_TH,
                          max_cluster_th: int = DEFAULT_MAX_CLUSTER,
                          *, pairs_fn: Callable[..., list] =
                          jaccard_pairs_topk) -> Clustering:
    """Alg. 3 — SpGEMM-driven candidate pairs + union–find merging.

    Follows the paper: top-K (= max_cluster_th − 1) candidate pairs per row
    from binarized SpGEMM(A·Aᵀ); a max-heap pops the most similar pair; if
    both endpoints are live cluster roots they merge; otherwise the pair is
    *re-scored* between the two current roots (lazily, with memoization via
    ``candidate_pairs``) and re-inserted if still above threshold. Cluster
    size is capped at ``max_cluster_th``. The final clusters are laid out
    contiguously (the implicit reordering the paper exploits), members in
    original-row order, clusters sequenced by their smallest member row —
    the layout is computed vectorized from the union–find roots.

    ``pairs_fn`` is the candidate-generator seam: the vectorized
    :func:`~repro_torch.core.similarity.jaccard_pairs_topk` by default, swap in
    ``jaccard_pairs_topk_reference`` to time/test the loop path.
    """
    if a.nrows == 0:
        return Clustering(boundaries=np.zeros(1, dtype=np.int64),
                          perm=np.zeros(0, dtype=np.int64),
                          max_cluster=max_cluster_th)
    topk = max(max_cluster_th - 1, 1)
    cand = pairs_fn(a, topk, jacc_th)
    seen: set[tuple[int, int]] = {(i, j) for _, i, j in cand}
    heap = [(-s, i, j) for s, i, j in cand]
    heapq.heapify(heap)
    uf = _UnionFind(a.nrows)

    while heap:
        negs, i, j = heapq.heappop(heap)
        ri, rj = uf.find(i), uf.find(j)
        if ri == rj:
            continue
        if i == ri and j == rj:
            if uf.size[ri] + uf.size[rj] <= max_cluster_th:
                uf.union(ri, rj)
            continue
        # endpoints stale → rescore between live roots (Alg. 3 lines 12–21)
        lo, hi = (ri, rj) if ri < rj else (rj, ri)
        if (lo, hi) in seen:
            continue
        seen.add((lo, hi))
        score = a.jaccard(lo, hi)
        if score > jacc_th and uf.size[lo] + uf.size[hi] <= max_cluster_th:
            heapq.heappush(heap, (-score, lo, hi))

    # vectorized layout: members sorted, clusters by min member
    root = uf.roots()
    min_member = np.full(a.nrows, a.nrows, dtype=np.int64)
    np.minimum.at(min_member, root, np.arange(a.nrows, dtype=np.int64))
    key = min_member[root]
    perm = np.lexsort((np.arange(a.nrows, dtype=np.int64), key))
    bounds = np.flatnonzero(boundary_mask(key[perm]))
    return Clustering(boundaries=bounds.astype(np.int64),
                      perm=perm.astype(np.int64),
                      max_cluster=max_cluster_th)
