"""The plain reference: A·B and A² in float64, and the comparison.

Plain PyTorch on the host, on the benchmark's own arrays (``graphs.Csr``
and dense numpy B). It imports nothing of the program: what the program
derived from these inputs (its permutations, packs, plans) plays no
part here. Values are small integers, so float64 sums are exact and an
exact answer differs from the reference by nothing.

The control (``control_product``) is the same product computed in
bfloat16, the precision one step below the float32 the program serves:
a program that cut its precision so would fail the comparison.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["product", "control_product", "max_abs_err"]


def _sparse(a, dtype=torch.float64, rounded=None) -> torch.Tensor:
    """``a`` as a sparse CSR tensor of ``dtype``, its values first
    rounded to ``rounded`` where given."""
    vals = torch.from_numpy(a.data.astype(np.float64))
    if rounded is not None:
        vals = vals.to(rounded)
    with warnings.catch_warnings():
        # the beta-state notice of sparse CSR tensors
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            vals.to(dtype), size=(a.n, a.n))


def product(a, b=None) -> np.ndarray:
    """Dense float64 ``a @ b`` for a dense numpy ``b``, or ``a @ a``
    when ``b`` is ``None``."""
    rhs = (_sparse(a).to_dense() if b is None
           else torch.from_numpy(np.asarray(b, dtype=np.float64)))
    return (_sparse(a) @ rhs).numpy()


def control_product(a, b=None, device="cpu") -> np.ndarray:
    """``a @ b`` (or ``a @ a``) as a bfloat16 product gives it: operands
    in bfloat16 (the values are small integers, which it holds exactly),
    products summed in float32, the result stored in bfloat16 — as a
    bfloat16 matrix multiply on the card does. Widened to float32 on the
    host. A stays sparse on ``device`` for ``a @ b``; ``a @ a`` makes it
    dense."""
    dev = torch.device(device)
    lhs = _sparse(a, torch.float32, torch.bfloat16).to(dev)
    if b is None:
        lhs = lhs.to_dense().to(torch.bfloat16)
        return (lhs @ lhs).float().cpu().numpy()
    rhs = torch.from_numpy(np.asarray(b, dtype=np.float32)).to(dev)
    rhs = rhs.to(torch.bfloat16).float()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = torch.sparse.mm(lhs, rhs)
    return out.to(torch.bfloat16).float().cpu().numpy()


def max_abs_err(got, want: np.ndarray) -> float:
    """Largest ``|got - want|``; infinite when the shapes differ or an
    entry of ``got`` is not finite."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return float("inf")
    err = np.abs(got.astype(np.float64) - want)
    if err.size == 0:
        return 0.0
    m = float(np.max(err))
    return m if np.isfinite(m) else float("inf")
