"""Trivial / signature-based reorderings: Original, Random, Degree, Gray."""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import HostCSR

__all__ = ["original", "random_shuffle", "degree_order", "gray_order"]


def original(a: HostCSR, seed: int = 0) -> np.ndarray:
    return np.arange(a.nrows, dtype=np.int64)


def random_shuffle(a: HostCSR, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    perm = np.arange(a.nrows, dtype=np.int64)
    rng.shuffle(perm)
    return perm


def degree_order(a: HostCSR, seed: int = 0) -> np.ndarray:
    """Descending row-nnz (paper: 'descending order of degrees'), stable."""
    nnz = a.row_nnz()
    return np.argsort(-nnz, kind="stable").astype(np.int64)


def _row_signatures(a: HostCSR, nbits: int) -> np.ndarray:
    """Bit signature per row: bit b set iff the row has a nonzero in column
    block b (ncols split into ``nbits`` equal blocks)."""
    block = max(1, -(-a.ncols // nbits))
    sig = np.zeros(a.nrows, dtype=np.uint64)
    row_ids = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    bits = (a.indices.astype(np.int64) // block).clip(0, nbits - 1)
    np.bitwise_or.at(sig, row_ids, (np.uint64(1) << bits.astype(np.uint64)))
    return sig


def _binary_to_gray(x: np.ndarray) -> np.ndarray:
    return x ^ (x >> np.uint64(1))


def gray_order(a: HostCSR, seed: int = 0, nbits: int = 48,
               dense_frac: float = 0.25) -> np.ndarray:
    """Gray-code ordering (Zhao et al. [51]).

    Rows are split into a *dense* group (row nnz above a quantile threshold)
    and a *sparse* group; within each group rows are sorted by the Gray code
    of their column-block signature so consecutive rows differ in few blocks.
    """
    nnz = a.row_nnz()
    thresh = np.quantile(nnz, 1.0 - dense_frac) if a.nrows else 0
    dense = nnz >= max(thresh, 1)
    gray = _binary_to_gray(_row_signatures(a, nbits))
    keys = np.lexsort((gray, ~dense))  # dense group first, gray within
    return keys.astype(np.int64)
