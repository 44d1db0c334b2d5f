"""The plain reference of a sparse A² returned as CSR: the product in
float64, its work, its control, and the comparison.

Plain PyTorch and numpy on the host, on the benchmark's own arrays
(``graphs.Csr``). It imports nothing of the program. Values are small
integers, so float64 sums are exact, and an exact answer has the
reference's row pointers and column indices and differs from its values
by nothing.

The control (``control_product``) is the same product stored in
bfloat16, the precision one step below the float32 the program serves:
a program that cut its precision so would fail the comparison.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from cardbench import roofline

__all__ = ["product", "control_product", "a2_csr_work", "max_abs_err"]

# rows of A per block of the product: bounds the product's temporaries
ROW_BLOCK = 1 << 17


def _csr(a, rows=slice(None)) -> torch.Tensor:
    """Rows ``rows`` of ``a`` as a float64 sparse CSR tensor."""
    lo, hi, _ = rows.indices(a.n)
    ptr = torch.from_numpy(a.indptr[lo: hi + 1].astype(np.int64))
    first, last = int(ptr[0]), int(ptr[-1])
    with warnings.catch_warnings():
        # the beta-state notice of sparse CSR tensors
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            ptr - first,
            torch.from_numpy(a.indices[first:last].astype(np.int64)),
            torch.from_numpy(a.data[first:last].astype(np.float64)),
            size=(hi - lo, a.n))


def product(a) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``a @ a`` in float64 as CSR arrays ``(indptr, indices, data)``:
    int64 row pointers, int64 column indices sorted within each row,
    float64 values. Computed ``ROW_BLOCK`` rows at a time."""
    rhs = _csr(a)
    ptrs, cols, vals = [np.zeros(1, np.int64)], [], []
    for lo in range(0, a.n, ROW_BLOCK):
        c = _csr(a, slice(lo, lo + ROW_BLOCK)) @ rhs
        ptr, col, val = c.crow_indices(), c.col_indices(), c.values()
        # sparse products leave a row's columns unsorted: sort by
        # (row, column)
        row = torch.repeat_interleave(torch.arange(ptr.shape[0] - 1),
                                      ptr[1:] - ptr[:-1])
        order = torch.argsort(row * a.n + col)
        ptrs.append(ptr[1:].numpy() + ptrs[-1][-1])
        cols.append(col[order].numpy())
        vals.append(val[order].numpy())
    return (np.concatenate(ptrs),
            np.concatenate(cols) if cols else np.zeros(0, np.int64),
            np.concatenate(vals) if vals else np.zeros(0, np.float64))


def control_product(a) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``a @ a`` as a bfloat16 product gives it: operands in bfloat16
    (the values are small integers, which it holds exactly), products
    summed in float32 (exact here, so equal to the float64 sums), the
    result stored in bfloat16. Widened to float32, as CSR arrays."""
    indptr, indices, data = product(a)
    stored = torch.from_numpy(data).float().to(torch.bfloat16)
    return indptr, indices, stored.float().numpy()


def a2_csr_work(a, c_nnz: int) -> tuple[int, int]:
    """(flops, bytes) of A·A with C returned as CSR: 2 per scalar
    product; A's CSR read twice (as the left and the right operand) and
    C's CSR, of ``c_nnz`` entries, written once (int32 row pointers and
    column indices, float32 values)."""
    flops, _ = roofline.a2_work(a.indptr, a.indices)

    def csr_bytes(nnz: int) -> int:
        return 4 * (a.n + 1) + 8 * nnz
    return flops, 2 * csr_bytes(a.nnz) + csr_bytes(int(c_nnz))


def max_abs_err(got, want) -> float:
    """Largest ``|got - want|`` over C's entries, ``got`` and ``want`` as
    ``(indptr, indices, data)``; infinite when the structure differs (row
    pointers or column indices) or a value of ``got`` is not finite."""
    (gp, gi, gd), (wp, wi, wd) = (tuple(np.asarray(x) for x in c)
                                  for c in (got, want))
    if not (np.array_equal(gp, wp) and np.array_equal(gi, wi)
            and gd.shape == wd.shape):
        return float("inf")
    if gd.size == 0:
        return 0.0
    m = float(np.max(np.abs(gd.astype(np.float64) - wd)))
    return m if np.isfinite(m) else float("inf")
