"""Structural validation of serving-request operands.

``SpGEMMServer.submit`` calls these at the request boundary so a
malformed matrix is rejected with a structured
:class:`~repro_torch.resilience.errors.InvalidOperandError` instead of
surfacing as an index error (or silent garbage) deep inside a packed
kernel. Checks are fully vectorized — a handful of O(nnz) numpy
reductions — so the guard stays inside the serving path's ≤2% overhead
budget (``benchmarks/bench_resilience.py`` gates it).

The checks mirror the :class:`repro_torch.core.formats.HostCSR` invariants its
docstring promises but its constructor (deliberately, for preprocessing
speed) does not enforce:

* ``indptr``: starts at 0, ends at ``nnz``, non-decreasing;
* ``indices``: within ``[0, ncols)`` and sorted ascending within a row;
* ``data``: finite (NaN/Inf would propagate through every kernel tier);
* ``shape``: consistent with ``indptr``/``indices``/``data`` lengths,
  and — for pair validation — compatible between A and B.

Duck-typed on purpose: no import of ``core.formats`` (the dependency
points the other way — ``HostCSR.validate()`` calls in here).
"""
from __future__ import annotations

import numpy as np

from repro_torch.resilience.errors import InvalidOperandError

__all__ = ["validate_host_csr", "validate_dense_operand",
           "validate_request_pair"]


def validate_host_csr(h, name: str = "operand") -> None:
    """Raise :class:`InvalidOperandError` unless ``h`` is a well-formed
    CSR matrix. ``name`` tags the message (``a`` / ``b`` at the serving
    boundary)."""
    nrows, ncols = h.shape
    indptr = h.indptr
    if nrows < 0 or ncols < 0:
        raise InvalidOperandError("shape", f"{name}: negative dimension",
                                  shape=h.shape)
    if indptr.shape[0] != nrows + 1:
        raise InvalidOperandError(
            "indptr", f"{name}: length must be nrows+1",
            expected=nrows + 1, got=int(indptr.shape[0]))
    if indptr[0] != 0:
        raise InvalidOperandError("indptr", f"{name}: must start at 0",
                                  got=int(indptr[0]))
    if int(indptr[-1]) != h.indices.shape[0]:
        raise InvalidOperandError(
            "indptr", f"{name}: end must equal nnz",
            expected=int(h.indices.shape[0]), got=int(indptr[-1]))
    diffs = np.diff(indptr)
    if diffs.size and int(diffs.min()) < 0:
        row = int(np.argmax(diffs < 0))
        raise InvalidOperandError(
            "indptr", f"{name}: not monotone non-decreasing", row=row)
    if h.indices.shape[0] != h.data.shape[0]:
        raise InvalidOperandError(
            "shape", f"{name}: indices/data length mismatch",
            indices=int(h.indices.shape[0]), data=int(h.data.shape[0]))
    if h.indices.size:
        lo = int(h.indices.min())
        hi = int(h.indices.max())
        if lo < 0 or hi >= ncols:
            raise InvalidOperandError(
                "indices", f"{name}: column index out of range [0, ncols)",
                min=lo, max=hi, ncols=ncols)
        # sorted-within-row: the only allowed descents in the flat index
        # stream are at row starts (one broadcast compare, no Python loop)
        descent = np.flatnonzero(np.diff(h.indices.astype(np.int64)) < 0) + 1
        if descent.size:
            row_starts = indptr[1:-1]
            bad = np.setdiff1d(descent, row_starts, assume_unique=False)
            if bad.size:
                pos = int(bad[0])
                row = int(np.searchsorted(indptr, pos, side="right")) - 1
                raise InvalidOperandError(
                    "indices", f"{name}: columns not sorted within row",
                    row=row)
    if h.data.size and not np.isfinite(float(np.sum(h.data,
                                                   dtype=np.float64))):
        # the float64 sum is one reduction and propagates any NaN/Inf;
        # only on failure do we pay the elementwise scan for the location
        bad = np.flatnonzero(~np.isfinite(h.data))
        pos = int(bad[0]) if bad.size else -1
        raise InvalidOperandError(
            "data", f"{name}: non-finite value", position=pos,
            value=(float(h.data[pos]) if pos >= 0 else float("nan")))


def validate_dense_operand(b, a_ncols: int) -> None:
    """Validate a dense (tall-skinny SpMM) right-hand side."""
    arr = np.asarray(b)
    if arr.ndim != 2:
        raise InvalidOperandError("shape", "dense b must be 2-D",
                                  ndim=arr.ndim)
    if arr.shape[0] != a_ncols:
        raise InvalidOperandError(
            "shape", "dense b rows must equal a.ncols",
            expected=a_ncols, got=int(arr.shape[0]))
    if arr.size and not np.isfinite(float(np.sum(
            arr, dtype=np.float64))):
        raise InvalidOperandError("data", "dense b: non-finite value")


def validate_request_pair(a, b=None, *, skip=None) -> None:
    """The :meth:`SpGEMMServer.submit` boundary check: ``a`` (always a
    sparse CSR), plus ``b`` when present — a second CSR (shape-chained)
    or a dense SpMM operand.

    ``skip`` is an optional ``obj -> bool`` predicate (the policy's
    validation memo): a True return skips that object's O(nnz) content
    scans — the serving contract treats submitted operands as immutable
    once accepted. Pairwise shape compatibility is never skipped (an
    operand validated in one pair can be shape-incompatible in the
    next)."""
    if skip is None or not skip(a):
        validate_host_csr(a, "a")
    if b is None:
        return
    if hasattr(b, "indptr"):            # HostCSR-shaped
        if skip is None or not skip(b):
            validate_host_csr(b, "b")
        if a.shape[1] != b.shape[0]:
            raise InvalidOperandError(
                "shape", "a.ncols must equal b.nrows",
                a_ncols=a.shape[1], b_nrows=b.shape[0])
    else:
        validate_dense_operand(b, a.shape[1])
