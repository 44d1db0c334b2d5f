"""Row-similarity machinery: Jaccard scores and the paper's SpGEMM-based
candidate-pair generation (binarized ``A·Aᵀ`` top-K; Alg. 3 lines 1–3).

The intersection size between the column sets of rows i and j is exactly
``(A_bin · A_binᵀ)[i, j]``; Jaccard follows from
``|i ∩ j| / (nnz_i + nnz_j − |i ∩ j|)``. We never materialize the full
(often dense-ish) product — the whole SpGEMM(A, Aᵀ) is computed as *one*
expanded COO join: every nonzero (i, c) of A is repeated through column
c's row list in Aᵀ, the expanded (i, j) stream is lexsorted, and run
lengths give the intersection counts. Segmented top-K retention then
matches the paper's formulation without a single Python-level per-row
loop (see :mod:`repro_torch.core.segment` for the primitives).

The original per-row loop implementations are retained verbatim as
``*_reference`` — they are the property-test oracles and the "before"
side of ``benchmarks/bench_preprocess.py``.
"""
from __future__ import annotations

import numpy as np

try:                                    # optional C SpGEMM for the candidate
    import scipy.sparse as _sparse      # product; the numpy segmented join
except ImportError:                     # below is the self-contained fallback
    _sparse = None

from repro_torch.core.formats import HostCSR
from repro_torch.core.segment import (boundary_mask, expand_indptr,
                                ragged_gather_indices, run_starts_lengths,
                                topk_mask)

__all__ = ["jaccard_pairs_topk", "jaccard_pairs_topk_reference",
           "pairwise_jaccard_consecutive",
           "pairwise_jaccard_consecutive_reference",
           "pairwise_jaccard_offset"]


def jaccard_pairs_topk(a: HostCSR, topk: int, jacc_th: float,
                       *, col_cap: int = 4096
                       ) -> list[tuple[float, int, int]]:
    """Candidate similar-row pairs via SpGEMM(A_bin · A_binᵀ) with top-K.

    Returns [(jaccard, i, j)] with i < j, score > jacc_th, at most ``topk``
    pairs retained per row. ``col_cap`` skips ultra-dense columns (their
    contribution to Jaccard is diluted anyway and they blow up the SpGEMM —
    same reasoning as SlashBurn's hub handling).

    Fully vectorized: intersection counts come from the sparse product
    ``A_nc · A_ncᵀ`` (capped columns zeroed) — scipy's C Gustavson SpGEMM
    when available, else a pure-numpy expanded COO join (ragged gather of
    Aᵀ's column lists + one fused-key sort whose run lengths are the
    counts). The per-row top-K is a segmented rank cut. Pair-for-pair
    identical (scores included) to :func:`jaccard_pairs_topk_reference`.
    """
    nnz = a.row_nnz()
    if _sparse is not None:
        pi, pj, inter = _candidate_counts_spgemm(a, col_cap)
    else:
        pi, pj, inter = _candidate_counts_join(a, col_cap)
    if pi.size == 0:
        return []
    union = nnz[pi] + nnz[pj] - inter
    jac = inter / np.maximum(union, 1)

    keep = jac > jacc_th
    pi, pj, jac = pi[keep], pj[keep], jac[keep]
    # segmented top-k per row i: descending jaccard, ties by ascending j
    # (exactly the reference's stable argsort(-jac) over ascending-j input)
    order = np.lexsort((pj, -jac, pi))
    pi, pj, jac = pi[order], pj[order], jac[order]
    sel = topk_mask(pi, topk)
    return list(zip(jac[sel].tolist(), pi[sel].tolist(), pj[sel].tolist()))


def _candidate_counts_spgemm(a: HostCSR, col_cap: int
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(i, j, |cols_i ∩ cols_j|) for i < j via scipy's C SpGEMM — the
    literal binarized A·Aᵀ of the paper, restricted to non-capped columns."""
    col_deg = np.bincount(a.indices, minlength=a.ncols)
    data = np.ones(a.nnz, dtype=np.int64)
    if (col_deg > col_cap).any():
        keep = col_deg[a.indices] <= col_cap
        m = _sparse.csr_matrix(
            (data[keep], a.indices[keep],
             np.concatenate([[0], np.cumsum(
                 np.bincount(expand_indptr(a.indptr)[keep],
                             minlength=a.nrows))])),
            shape=a.shape)
    else:
        m = _sparse.csr_matrix((data, a.indices, a.indptr), shape=a.shape)
    prod = m @ m.T
    # read the CSR product directly (tocoo() would copy all three arrays)
    rows = expand_indptr(prod.indptr)
    cols = prod.indices
    upper = cols > rows
    return (rows[upper], cols[upper].astype(np.int64), prod.data[upper])


def _candidate_counts_join(a: HostCSR, col_cap: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-numpy fallback for :func:`_candidate_counts_spgemm`: expand each
    nonzero (i, c) of A through Aᵀ's row list of column c; one fused int64
    key per expanded candidate (built with a single allocation + in-place
    add) whose sorted run lengths are exactly the intersection sizes."""
    at = a.transpose()
    col_deg = at.row_nnz()
    nz_row = expand_indptr(a.indptr).astype(np.int32)  # row id per nnz of A
    cols = a.indices.astype(np.int64)
    lens = np.where(col_deg[cols] <= col_cap, col_deg[cols], 0)
    gather = ragged_gather_indices(at.indptr[cols], lens)
    if gather.size == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty, empty
    cand_j = at.indices[gather]                       # candidate partner row
    cand_i = np.repeat(nz_row, lens)
    key = np.multiply(cand_i, np.int64(a.nrows), dtype=np.int64)
    key += cand_j
    key.sort()
    starts, inter = run_starts_lengths(key)
    pi, pj = key[starts] // a.nrows, key[starts] % a.nrows
    upper = pj > pi                                   # dedupe (i, j), i < j
    return pi[upper], pj[upper], inter[upper]


def jaccard_pairs_topk_reference(a: HostCSR, topk: int, jacc_th: float,
                                 *, col_cap: int = 4096
                                 ) -> list[tuple[float, int, int]]:
    """Loop reference for :func:`jaccard_pairs_topk` (property-test oracle)."""
    at = a.transpose()
    nnz = a.row_nnz()
    pairs: dict[tuple[int, int], float] = {}
    counts = np.zeros(a.nrows, dtype=np.int64)
    for i in range(a.nrows):
        cols, _ = a.row(i)
        if cols.size == 0:
            continue
        touched: list[np.ndarray] = []
        for c in cols:
            rows_c = at.row(int(c))[0]
            if rows_c.size > col_cap:
                continue
            touched.append(rows_c)
        if not touched:
            continue
        cand = np.concatenate(touched).astype(np.int64)
        cand = cand[cand > i]             # dedupe (i, j) with i < j
        if cand.size == 0:
            continue
        js, inter = np.unique(cand, return_counts=True)
        union = nnz[i] + nnz[js] - inter
        jac = inter / np.maximum(union, 1)
        keep = jac > jacc_th
        js, jac = js[keep], jac[keep]
        if js.size > topk:
            sel = np.argsort(-jac, kind="stable")[:topk]
            js, jac = js[sel], jac[sel]
        for j, s in zip(js, jac):
            if counts[i] >= topk:
                break
            pairs[(i, int(j))] = float(s)
            counts[i] += 1
    return [(s, i, j) for (i, j), s in pairs.items()]


def pairwise_jaccard_offset(a: HostCSR, offset: int = 1) -> np.ndarray:
    """Jaccard(i, i+offset) for all rows at once, via one sorted merge.

    Each nonzero (r, c) contributes the key ``p * ncols + c`` for pair
    ``p = r`` (as the left row) and pair ``p = r - offset`` (as the right
    row); after one sort, intersection elements are exactly the duplicated
    keys. Returns an array of length ``max(nrows - offset, 0)``.
    """
    n = a.nrows - offset
    if n <= 0:
        return np.zeros(0, dtype=np.float64)
    rows = expand_indptr(a.indptr)
    cols = a.indices.astype(np.int64)
    ncols = max(a.ncols, 1)
    left = rows < n
    right = rows >= offset
    keys = np.concatenate([rows[left] * ncols + cols[left],
                           (rows[right] - offset) * ncols + cols[right]])
    keys.sort(kind="stable")
    dup = keys[1:] == keys[:-1]
    inter = np.bincount(keys[1:][dup] // ncols, minlength=n)
    nnz = a.row_nnz()
    union = nnz[:n] + nnz[offset:] - inter
    # both rows empty -> union 0 -> Jaccard 1.0 by convention
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def pairwise_jaccard_consecutive(a: HostCSR) -> np.ndarray:
    """Jaccard(i, i+1) for all consecutive row pairs — one sorted merge."""
    return pairwise_jaccard_offset(a, 1)


def pairwise_jaccard_consecutive_reference(a: HostCSR) -> np.ndarray:
    """Loop reference for :func:`pairwise_jaccard_consecutive`."""
    out = np.zeros(max(a.nrows - 1, 0), dtype=np.float64)
    for i in range(a.nrows - 1):
        out[i] = a.jaccard(i, i + 1)
    return out
