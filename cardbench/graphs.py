"""The benchmark's own sparse matrices: frozen generators and a plain CSR.

The four generators and ``_sym_coo`` are frozen copies of the port's
synthetic suite (``repro_torch.core.suite``), kept here so that a change
to the program cannot change the benchmark's inputs. They return a
:class:`Csr` of plain numpy arrays; the harness wraps it into the
program's operand type, and the reference reads the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Csr", "from_coo", "gen_kron", "gen_caveman", "gen_powerlaw",
           "gen_mesh2d", "GENERATORS", "relabel", "integer_values"]


@dataclasses.dataclass(frozen=True)
class Csr:
    """A square CSR matrix: int64 ``indptr``, int32 sorted ``indices``
    within each row, float32 ``data``."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])


def from_coo(rows, cols, vals, n: int) -> Csr:
    """CSR from COO triplets, duplicates summed in the order they come
    (as the program's ``HostCSR.from_coo``, by one stable sort)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    if key.size:
        first = np.empty(key.shape[0], dtype=bool)
        first[0] = True
        np.not_equal(key[1:], key[:-1], out=first[1:])
        inv = np.cumsum(first) - 1
        summed = np.bincount(inv, weights=vals.astype(np.float64))
        key, vals = key[first], summed.astype(np.float32)
    rows, cols = key // n, key % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return Csr(indptr, cols.astype(np.int32), vals, n)


def _sym_coo(n: int, rows, cols, rng) -> Csr:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = rng.uniform(0.5, 1.5, size=r.shape[0]).astype(np.float32)
    return from_coo(r, c, v, n)


def gen_mesh2d(side: int, seed: int = 0, stencil: int = 5) -> Csr:
    """2-D grid Laplacian pattern (5- or 9-point)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    idx = (ii * side + jj).ravel()
    rows, cols = [], []
    offsets = [(0, 1), (1, 0)]
    if stencil == 9:
        offsets += [(1, 1), (1, -1)]
    for di, dj in offsets:
        ni, nj = ii + di, jj + dj
        ok = (ni >= 0) & (ni < side) & (nj >= 0) & (nj < side)
        rows.append(idx.reshape(side, side)[ok])
        cols.append((ni * side + nj)[ok])
    return _sym_coo(n, np.concatenate(rows), np.concatenate(cols), rng)


def gen_powerlaw(n: int, avg_deg: int = 12, seed: int = 0) -> Csr:
    """Preferential-attachment (Barabási–Albert-style) power-law graph."""
    rng = np.random.default_rng(seed)
    m = max(1, avg_deg // 2)
    rows, cols = [], []
    repeated: list[int] = list(range(m))
    for v in range(m, n):
        picks = rng.choice(len(repeated), size=m, replace=True)
        chosen = {repeated[p] for p in picks}
        for u in chosen:
            rows.append(v)
            cols.append(u)
            repeated.extend((v, u))
    return _sym_coo(n, rows, cols, rng)


def gen_kron(scale: int, edge_factor: int = 10, seed: int = 0,
             initiator=(0.57, 0.19, 0.19, 0.05)) -> Csr:
    """R-MAT / Kronecker generator with the ``initiator`` probabilities
    (a, b, c, d) — by default Graph500's — made symmetric, with the
    diagonal."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    a_, b_, c_, d_ = (float(p) for p in initiator)
    if abs(a_ + b_ + c_ + d_ - 1.0) > 1e-9:
        raise ValueError(f"initiator {initiator} does not sum to 1")
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(m)
        bit_r = (r > a_ + b_).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(bit_r == 0, b_ / (a_ + b_), (1 - a_ - b_ - c_)
                       / max(1 - a_ - b_, 1e-9))
        bit_c = (r2 < thr).astype(np.int64)
        rows |= bit_r << lvl
        cols |= bit_c << lvl
    return _sym_coo(n, rows, cols, rng)


def gen_caveman(n: int, cave: int = 24, rewire: float = 0.05,
                seed: int = 0) -> Csr:
    """Connected-caveman communities."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b0 in range(0, n, cave):
        sz = min(cave, n - b0)
        r, c = np.meshgrid(np.arange(sz), np.arange(sz), indexing="ij")
        keep = (r < c) & (rng.random((sz, sz)) < 0.6)
        rows.append(b0 + r[keep])
        cols.append(b0 + c[keep])
    m = int(rewire * n)
    rows.append(rng.integers(0, n, m))
    cols.append(rng.integers(0, n, m))
    return _sym_coo(n, np.concatenate(rows), np.concatenate(cols), rng)


GENERATORS = {"kron": gen_kron, "caveman": gen_caveman,
              "powerlaw": gen_powerlaw, "mesh2d": gen_mesh2d}


def relabel(a: Csr, perm: np.ndarray) -> Csr:
    """P·A·Pᵀ with vertex ``perm[i]`` of ``a`` renamed ``i``: row ``i`` of
    the result is row ``perm[i]`` of ``a``, columns renamed alike and
    sorted again within each row."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(a.n)
    lens = np.diff(a.indptr)[perm]
    indptr = np.zeros(a.n + 1, dtype=np.int64)
    np.cumsum(lens, out=indptr[1:])
    src = np.repeat(a.indptr[perm], lens) + (
        np.arange(indptr[-1]) - np.repeat(indptr[:-1], lens))
    cols = inv[a.indices[src].astype(np.int64)]
    rows = np.repeat(np.arange(a.n), lens)
    order = np.argsort(rows * a.n + cols, kind="stable")
    return Csr(indptr, cols[order].astype(np.int32), a.data[src][order], a.n)


def integer_values(a: Csr, rng: np.random.Generator,
                   values=(1, 2, 3), dtype="float32") -> Csr:
    """The same pattern with values drawn uniformly from ``values``,
    stored as ``dtype``: sums of small integers are exact in float32 in
    any order."""
    v = rng.choice(np.asarray(values, dtype=np.float32), size=a.nnz)
    return Csr(a.indptr, a.indices, v.astype(dtype), a.n)
