"""Structural feature extraction + pattern fingerprinting for the planner.

The planner's premise (following "Is Sparse Matrix Reordering Effective
for SpMV?" and Nagasaka et al.'s method-selection-by-row-distribution) is
that *cheap structural features* predict which reordering/clustering pays
off — without running any of them. Everything here is vectorized over the
existing segmented-CSR machinery: no per-row Python loops, cost O(nnz) or
O(nnz · small-constant) per matrix.

Two exports matter downstream:

* :func:`extract_features` — a :class:`MatrixFeatures` record consumed by
  ``cost_model.rank``;
* :func:`fingerprint` — a stable *pattern* digest (shape + indptr +
  indices; values excluded) keying the plan cache. Two matrices with the
  same sparsity pattern but different values share a plan: reordering and
  clustering decisions depend only on structure.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.formats import HostCSR, tiled_live_tiles
from repro_torch.core.segment import expand_indptr
from repro_torch.core.similarity import (jaccard_pairs_topk,
                                   pairwise_jaccard_consecutive)

__all__ = ["MatrixFeatures", "extract_features", "fingerprint",
           "FINGERPRINT_VERSION"]

# bump when the digest recipe changes — a stale on-disk plan keyed by an
# old recipe must never match a new fingerprint
FINGERPRINT_VERSION = "fp1"


def fingerprint(a: HostCSR) -> str:
    """Stable hex digest of the sparsity *pattern* of ``a``.

    Hashes (version, shape, indptr, indices) — values are deliberately
    excluded, so perturbing the numeric entries of a matrix keeps its
    fingerprint (and its cached plan) valid.
    """
    h = hashlib.sha256()
    h.update(FINGERPRINT_VERSION.encode())
    h.update(np.asarray(a.shape, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(a.indices, dtype=np.int32).tobytes())
    return f"{FINGERPRINT_VERSION}-{h.hexdigest()[:24]}"


@dataclasses.dataclass(frozen=True)
class MatrixFeatures:
    """Cheap structural descriptors of a sparsity pattern.

    All ratio-valued fields are scale-free so the cost model transfers
    across matrix sizes.
    """

    nrows: int
    ncols: int
    nnz: int
    density: float            # nnz / (nrows * ncols)
    row_mean: float           # mean row length
    row_cv: float             # row-length coefficient of variation (skew)
    row_gini: float           # row-length Gini coefficient (hub-ness)
    row_max_frac: float       # max row length / ncols
    bandwidth_mean: float     # mean |i - j| / max(n-1, 1)  (disorder proxy)
    bandwidth_p95: float      # 95th percentile of |i - j| / max(n-1, 1)
    diag_frac: float          # fraction of nnz on the diagonal
    consec_jaccard: float     # mean Jaccard(i, i+1) — as-ordered locality
    similar_frac: float       # retained top-1 (i<j) pairs ÷ rows — a lower
    #                           bound on partner coverage (a mutual pair
    #                           covers two rows but counts once); the cost
    #                           model is calibrated on THIS quantity
    similar_mean: float       # mean Jaccard over those retained pairs
    tile128_fill: float       # nnz ÷ (live 128×128 tiles × 128²) — fill of
    #                           the live tile lattice, as ordered; the
    #                           tiled kernel path's traffic gate (its B
    #                           bytes scale with 1/fill, the gather path's
    #                           with row length)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _gini(x: np.ndarray) -> float:
    """Gini coefficient of a nonnegative vector (0 = uniform, →1 = hubs)."""
    if x.size == 0:
        return 0.0
    s = np.sort(x.astype(np.float64))
    total = s.sum()
    if total <= 0:
        return 0.0
    n = s.size
    # standard rank formulation: G = (2 Σ i·x_(i) / (n Σ x)) − (n+1)/n
    idx = np.arange(1, n + 1, dtype=np.float64)
    return float(2.0 * (idx * s).sum() / (n * total) - (n + 1) / n)


def extract_features(a: HostCSR, *, similarity: bool = True,
                     similarity_th: float = 0.2,
                     similarity_row_cap: int = 8192) -> MatrixFeatures:
    """Vectorized feature pass over ``a``.

    ``similarity=True`` additionally runs the segmented A·Aᵀ candidate
    generator (``jaccard_pairs_topk``, top-1 per row) — the clustering
    coefficient proxy that predicts whether *any* clustering scheme can
    find reusable B-rows. It is the most expensive feature (one binarized
    SpGEMM), so matrices above ``similarity_row_cap`` rows use the head
    block only; pass ``similarity=False`` for a pure O(nnz) pass.
    """
    n, m = a.shape
    nnz = a.nnz
    lens = a.row_nnz().astype(np.float64)
    row_mean = float(lens.mean()) if n else 0.0
    row_std = float(lens.std()) if n else 0.0
    rows = expand_indptr(a.indptr).astype(np.int64)
    cols = a.indices.astype(np.int64)
    if nnz:
        dist = np.abs(rows - cols) / max(n - 1, 1)
        bw_mean = float(dist.mean())
        bw_p95 = float(np.percentile(dist, 95))
        diag_frac = float((rows == cols).mean())
    else:
        bw_mean = bw_p95 = diag_frac = 0.0
    cj = pairwise_jaccard_consecutive(a)
    consec = float(cj.mean()) if cj.size else 0.0
    if nnz:
        live = tiled_live_tiles(a, 128, 128)
        tile_fill = float(nnz / (live * 128 * 128))
    else:
        tile_fill = 0.0

    similar_frac = similar_mean = 0.0
    if similarity and nnz:
        s = a
        if n > similarity_row_cap:
            # head block: suite generators lay families out stationarily,
            # so a prefix is a fair structural sample
            cut = int(a.indptr[similarity_row_cap])
            s = HostCSR(a.indptr[: similarity_row_cap + 1],
                        a.indices[:cut], a.data[:cut],
                        (similarity_row_cap, m))
        pairs = jaccard_pairs_topk(s, topk=1, jacc_th=similarity_th)
        if pairs:
            scores = np.asarray([p[0] for p in pairs])
            similar_frac = float(len(pairs) / max(s.nrows, 1))
            similar_mean = float(scores.mean())

    return MatrixFeatures(
        nrows=n, ncols=m, nnz=nnz,
        density=float(nnz / max(n * m, 1)),
        row_mean=row_mean,
        row_cv=float(row_std / max(row_mean, 1e-12)),
        row_gini=_gini(lens),
        row_max_frac=float(lens.max() / max(m, 1)) if n else 0.0,
        bandwidth_mean=bw_mean,
        bandwidth_p95=bw_p95,
        diag_frac=diag_frac,
        consec_jaccard=consec,
        similar_frac=similar_frac,
        similar_mean=similar_mean,
        tile128_fill=tile_fill,
    )
