"""Work counts of the served products, the card's peaks, its power limit.

The least time a product needs is the larger of its bytes over the
card's memory bandwidth and its operations over its float32 rate. The
bytes are what these inputs need whichever tier computes the product:
A's CSR read once (int32 row pointers and column indices, float32
values), B read once, C written once. An operation is a multiply or an
add: 2 per stored entry of A per column of B.
"""
from __future__ import annotations

import shutil
import subprocess

import numpy as np

__all__ = ["H100_SXM", "spmm_work", "a2_work", "least_s",
           "power_limit_w"]

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit
H100_SXM = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}


def _csr_bytes(n: int, nnz: int) -> int:
    return 4 * (n + 1) + 8 * nnz


def spmm_work(n: int, nnz: int, k: int) -> tuple[int, int]:
    """(flops, bytes) of A·B for an n × n A with ``nnz`` entries and a
    dense n × k float32 B."""
    return 2 * nnz * k, _csr_bytes(n, nnz) + 2 * 4 * n * k


def a2_work(indptr, indices) -> tuple[int, int]:
    """(flops, bytes) of A·A with a dense float32 n × n C: each entry
    (i, j) of A meets the nnz(row j) entries of row j; A is read once as
    the left and once as the right operand."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    row_len = np.diff(indptr)
    products = int(row_len[np.asarray(indices, dtype=np.int64)].sum())
    return 2 * products, 2 * _csr_bytes(n, nnz) + 4 * n * n


def least_s(flops: float, nbytes: float, peaks=H100_SXM) -> float:
    """The least time the card needs for this work."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flops_per_s"])


def _smi(query: str) -> str:
    if shutil.which("nvidia-smi") is None:
        return ""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def power_limit_w() -> float | None:
    """The first card's power limit in watts, or ``None`` unread."""
    try:
        return float(_smi("power.limit"))
    except ValueError:
        return None
