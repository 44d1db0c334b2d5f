"""Segmented-CSR primitive library — the vectorized substrate of the host
preprocessing pipeline.

Every preprocessing stage (similarity candidate generation, clustering,
format packing) reduces to a handful of bandwidth-shaped primitives over
*segments*: contiguous runs of a flat array delimited either by a CSR
``indptr`` or by equal keys after a sort. This module provides those
primitives in pure numpy with zero Python-level per-element loops, in the
spirit of the sort/segment/scan formulation that Nagasaka et al.
(arXiv:1804.01698) and propagation-blocking (arXiv:2002.11302) use to make
SpGEMM-adjacent preprocessing itself bandwidth-bound:

* ``expand_indptr``         — segment id of every element under an indptr
  (``np.repeat`` over ``diff``; the inverse of a counting sort).
* ``ragged_gather_indices`` — flat gather plan that concatenates
  ``src[starts[k] : starts[k] + lengths[k]]`` for all ``k`` at once.
* ``boundary_mask`` / ``run_starts_lengths`` — run detection over sorted
  keys (the "segmented unique" building block).
* ``rank_in_segment``       — position of each element within its run;
  composing with a lexsort gives segmented sort / segmented top-k.
* ``segmented_count`` / ``segmented_sum`` — bincount-backed reductions.

Conventions: segment ids are int64 and non-decreasing where the docstring
says "sorted"; empty inputs produce empty outputs of the right dtype.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "expand_indptr",
    "segment_offsets",
    "ragged_gather_indices",
    "boundary_mask",
    "run_starts_lengths",
    "rank_in_segment",
    "segmented_count",
    "segmented_sum",
    "topk_mask",
    "key_table",
]


def expand_indptr(indptr: np.ndarray) -> np.ndarray:
    """Segment id of every element: ``[0]*n0 + [1]*n1 + ...`` for the CSR
    ``indptr`` with ``nk = indptr[k+1] - indptr[k]``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    return np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))


def segment_offsets(lengths: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum of segment lengths (start offset of each
    segment in the concatenated flat array)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    offs = np.zeros(lengths.shape[0], dtype=np.int64)
    np.cumsum(lengths[:-1], out=offs[1:])
    return offs


def ragged_gather_indices(starts: np.ndarray,
                          lengths: np.ndarray) -> np.ndarray:
    """Flat indices that concatenate ``src[starts[k]:starts[k]+lengths[k]]``.

    The workhorse of ragged joins: expanding A's rows through Aᵀ's column
    lists is one call of this against ``at.indptr``/``at.row_nnz()``.
    """
    starts = np.asarray(starts, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    offs = segment_offsets(lengths)
    # int32 when the expansion fits — the output is often the largest
    # array a preprocessing pass touches, so width is bandwidth
    hi = int((starts + lengths).max())
    dtype = np.int32 if hi < 2**31 and total < 2**31 else np.int64
    return (np.repeat((starts - offs).astype(dtype), lengths)
            + np.arange(total, dtype=dtype))


def boundary_mask(*sorted_keys: np.ndarray) -> np.ndarray:
    """True at the first element of each equal-key run. Multiple key arrays
    are compared elementwise (a run ends when *any* key changes)."""
    n = sorted_keys[0].shape[0]
    mask = np.zeros(n, dtype=bool)
    if n == 0:
        return mask
    mask[0] = True
    for k in sorted_keys:
        mask[1:] |= k[1:] != k[:-1]
    return mask


def run_starts_lengths(*sorted_keys: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of equal-key runs — segmented ``unique`` with
    counts, without re-deriving the values (index ``keys[starts]``)."""
    mask = boundary_mask(*sorted_keys)
    starts = np.flatnonzero(mask)
    n = sorted_keys[0].shape[0]
    lengths = np.diff(np.append(starts, n))
    return starts, lengths


def rank_in_segment(sorted_seg: np.ndarray) -> np.ndarray:
    """0-based position of each element within its run of equal segment
    ids (``sorted_seg`` non-decreasing). After a lexsort whose primary key
    is the segment and secondary key is a score, ``rank < k`` is a
    segmented top-k mask."""
    sorted_seg = np.asarray(sorted_seg)
    starts, lengths = run_starts_lengths(sorted_seg)
    return (np.arange(sorted_seg.shape[0], dtype=np.int64)
            - np.repeat(starts, lengths))


def segmented_count(seg: np.ndarray, nseg: int) -> np.ndarray:
    """Number of elements per segment id (ids need not be sorted)."""
    return np.bincount(np.asarray(seg, dtype=np.int64), minlength=nseg)


def segmented_sum(seg: np.ndarray, values: np.ndarray,
                  nseg: int) -> np.ndarray:
    """Sum of ``values`` per segment id (ids need not be sorted)."""
    return np.bincount(np.asarray(seg, dtype=np.int64), weights=values,
                       minlength=nseg)


def topk_mask(sorted_seg: np.ndarray, k: int) -> np.ndarray:
    """Keep-mask of the first ``k`` elements of each segment; sort by
    (segment, -score) first to make this a segmented top-k by score."""
    return rank_in_segment(sorted_seg) < k


def key_table(unique_keys: np.ndarray, table_size: int, *,
              base: int = 0) -> np.ndarray:
    """Dense int32 lookup table: ``table[unique_keys[i]] = base + i``,
    everything else 0.

    The inverse of a compaction — turns a sorted list of live keys into
    the O(1) key→slot map a scalar-prefetched kernel indexes (``base=1``
    reserves slot 0 for the "dead key" sentinel, the convention of
    :class:`repro_torch.core.formats.TiledCSR`)."""
    unique_keys = np.asarray(unique_keys, dtype=np.int64)
    table = np.zeros(table_size, dtype=np.int32)
    table[unique_keys] = base + np.arange(unique_keys.shape[0],
                                          dtype=np.int32)
    return table
