"""SpGEMM / SpMM compute: row-wise (Gustavson) and cluster-wise (Alg. 1) —
the gather/scatter tier that serves every planner scheme but ``pallas``.

These are plain tensor programs (gathers, ``index_put_`` / ``index_add_``
scatters), the port's counterpart of the JAX package's XLA passes in
``core/spgemm.py``. Outputs are dense accumulators (M×N).

Dataflow (paper → here):

* row-wise Gustavson: one gather of a B row per *nonzero* of A
  (:func:`spgemm_rowwise_dense_binned` / :func:`spmm_rowwise`);
* cluster-wise (Alg. 1): one gather of a B row per *(cluster, column)*
  slot — deduplicated across the rows of the cluster — then an outer
  product against the cluster's value slab
  (:func:`spgemm_clusterwise_dense_binned` / :func:`spmm_clusterwise`).

The unbinned :func:`spgemm_rowwise_dense` / :func:`spgemm_clusterwise_dense`
pad every gather to one global width: the oracles the binned passes are
held against. The paper's work counters (:func:`symbolic_nnz`,
:func:`gathers_rowwise`, :func:`b_bytes_rowwise_binned`, …) are host-side
numpy, as in the JAX package.

Scatter-adds on a CUDA device accumulate with atomics, so float sums may
differ from run to run in the last bits; integer-valued operands are
exact in any order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import CSR, CSRCluster, HostCSR

__all__ = [
    "spgemm_rowwise_dense", "spgemm_clusterwise_dense",
    "spgemm_rowwise_dense_binned", "spgemm_clusterwise_dense_binned",
    "length_bins", "slot_rows_host", "spmm_rowwise", "spmm_clusterwise",
    "spgemm_reference", "symbolic_nnz", "symbolic_row_nnz", "flops_spgemm",
    "gathers_rowwise", "gathers_clusterwise", "b_bytes_rowwise_binned",
    "b_bytes_tiled",
]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _slot_rows(indptr: torch.Tensor, cap: int) -> torch.Tensor:
    """Row id of each storage slot (padded slots map past the last row)."""
    slots = torch.arange(cap, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr, slots, right=True).long() - 1


def slot_rows_host(indptr: np.ndarray, cap: int) -> np.ndarray:
    """Host-side row id of each of ``cap`` storage slots. Precomputed once
    per packed operand and threaded through every bin pass."""
    return (np.searchsorted(np.asarray(indptr),
                            np.arange(cap, dtype=np.int64),
                            side="right") - 1).astype(np.int32)


def _gather_b_rows(b: CSR, k: torch.Tensor, max_row_b: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width gather of B rows ``k`` (any shape): (cols, vals) with a
    trailing width axis, masked past each row's end. ``k`` may be the
    padding sentinel ``b.nrows`` — yields an empty row."""
    k = torch.clamp(k, 0, b.nrows)
    indptr = b.indptr.long()
    start = indptr[k]
    length = indptr[torch.clamp(k + 1, 0, b.nrows)] - start
    offs = torch.arange(max_row_b, dtype=torch.int64, device=k.device)
    idx = torch.clamp(start[..., None] + offs, 0, b.nnz_cap - 1)
    mask = offs < length[..., None]
    cols = torch.where(mask, b.indices.long()[idx], b.ncols)
    vals = torch.where(mask, b.data[idx], 0)
    return cols, vals


# ---------------------------------------------------------------------------
# sparse × sparse (A², paper §4.2–4.3): the unbinned oracles
# ---------------------------------------------------------------------------


def spgemm_rowwise_dense(a: CSR, b: CSR, max_row_b: int) -> torch.Tensor:
    """Gustavson row-wise SpGEMM, every gather ``max_row_b`` wide; returns
    dense C (nrows_a × ncols_b) on A's device."""
    rows = _slot_rows(a.indptr, a.nnz_cap)
    ks = a.indices.long()
    valid = ks < a.ncols
    bcols, bvals = _gather_b_rows(b, torch.where(valid, ks, b.nrows),
                                  max_row_b)
    prod = a.data[:, None] * bvals                        # (nnz_a, W)
    out_rows = torch.clamp(rows, 0, a.nrows - 1)[:, None].expand(prod.shape)
    out_cols = torch.clamp(bcols, max=b.ncols)
    c = torch.zeros((a.nrows, b.ncols + 1), dtype=prod.dtype,
                    device=prod.device)
    c.index_put_((out_rows, out_cols), prod, accumulate=True)
    return c[:, : b.ncols]


def spgemm_clusterwise_dense(a: CSRCluster, b: CSR,
                             max_row_b: int) -> torch.Tensor:
    """Cluster-wise SpGEMM (Alg. 1), every gather ``max_row_b`` wide; one
    B-row gather per (cluster, column) slot, applied to *all* rows of the
    cluster through an outer product with the value slab. Returns dense C.
    """
    cl = torch.clamp(_slot_rows(a.cluster_ptr, a.slot_cap), 0,
                     a.nclusters - 1)
    ks = a.cols.long()
    valid = ks < a.ncols
    bcols, bvals = _gather_b_rows(b, torch.where(valid, ks, b.nrows),
                                  max_row_b)
    prod = bvals[:, :, None] * a.values[:, None, :]       # (S, W, K)
    base = torch.clamp(a.row_base.long()[cl], 0, a.nrows)
    kk = torch.arange(a.max_cluster, dtype=torch.int64, device=prod.device)
    rows = base[:, None, None] + kk                       # (S, 1, K)
    cols = torch.clamp(bcols, max=b.ncols)[:, :, None]    # (S, W, 1)
    c = torch.zeros((a.nrows + a.max_cluster, b.ncols + 1),
                    dtype=prod.dtype, device=prod.device)
    c.index_put_((rows.expand(prod.shape), cols.expand(prod.shape)), prod,
                 accumulate=True)
    return c[: a.nrows, : b.ncols]


# ---------------------------------------------------------------------------
# length-binned sparse × sparse (A², paper §4.2–4.3)
#
# A host-computed partition of the storage slots by pow2 bucket of their
# fetched B-row length; one pass per bin, so each slot pays the
# gather/scatter width of *its* row, not the global maximum. Slots
# fetching empty rows are dropped outright.
# ---------------------------------------------------------------------------


def length_bins(fetch_lens: np.ndarray, *, floor: int = 8,
                pad_sentinel: int | None = None
                ) -> list[tuple[np.ndarray, int]]:
    """Partition slot ids 0..len(fetch_lens)-1 by pow2 bucket of their
    fetched B-row length.

    Returns [(slot_ids, width)] with slot_ids padded to a pow2 length using
    ``pad_sentinel`` (default: len(fetch_lens), i.e. one past the last slot
    — the passes mask slots >= their cap). Zero-length fetches appear in
    no bin.
    """
    fetch_lens = np.asarray(fetch_lens, dtype=np.int64)
    sentinel = (int(fetch_lens.shape[0]) if pad_sentinel is None
                else pad_sentinel)
    live = np.flatnonzero(fetch_lens > 0)
    if live.size == 0:
        return []
    widths = np.maximum(fetch_lens[live], 1)
    buckets = np.maximum(floor, 2 ** np.ceil(np.log2(widths)).astype(int))
    bins: list[tuple[np.ndarray, int]] = []
    for w in np.unique(buckets):
        slots = live[buckets == w]
        cap = max(8, 1 << (int(slots.size) - 1).bit_length())
        padded = np.full(cap, sentinel, dtype=np.int32)
        padded[: slots.size] = slots
        bins.append((padded, int(w)))
    return bins


def _rowwise_pass(a: CSR, b: CSR, slots: torch.Tensor, c: torch.Tensor,
                  slot_rows: torch.Tensor, max_row_b: int) -> None:
    valid_slot = slots < a.nnz_cap
    sl = torch.clamp(slots, 0, a.nnz_cap - 1)
    rows = slot_rows[sl]
    ks = torch.where(valid_slot, a.indices.long()[sl], a.ncols)
    data = torch.where(valid_slot, a.data[sl], 0)
    valid = ks < a.ncols
    bcols, bvals = _gather_b_rows(b, torch.where(valid, ks, b.nrows),
                                  max_row_b)
    prod = data[:, None] * bvals
    out_rows = torch.clamp(rows, 0, a.nrows - 1)[:, None].expand(prod.shape)
    out_cols = torch.clamp(bcols, max=b.ncols)
    c.index_put_((out_rows, out_cols), prod, accumulate=True)


def spgemm_rowwise_dense_binned(a: CSR, b: CSR,
                                bins: list[tuple[np.ndarray, int]],
                                slot_rows: np.ndarray | None = None
                                ) -> torch.Tensor:
    """Row-wise (Gustavson) SpGEMM with per-bin gather widths; returns
    dense C (nrows_a × ncols_b) on A's device.

    ``slot_rows`` — optional precomputed slot→row map
    (:func:`slot_rows_host`); computed once here otherwise.
    """
    dev = a.data.device
    if slot_rows is None:
        sr = _slot_rows(a.indptr, a.nnz_cap)
    else:
        sr = torch.as_tensor(slot_rows, device=dev).long()
    c = torch.zeros((a.nrows, b.ncols + 1), dtype=a.data.dtype, device=dev)
    for slots, w in bins:
        _rowwise_pass(a, b, torch.as_tensor(slots, device=dev).long(), c,
                      sr, w)
    return c[:, : b.ncols]


def _clusterwise_pass(a: CSRCluster, b: CSR, slots: torch.Tensor,
                      c: torch.Tensor, slot_clusters: torch.Tensor,
                      max_row_b: int) -> None:
    valid_slot = slots < a.slot_cap
    sl = torch.clamp(slots, 0, a.slot_cap - 1)
    cl = torch.clamp(slot_clusters[sl], 0, a.nclusters - 1)
    ks = torch.where(valid_slot, a.cols.long()[sl], a.ncols)
    slab = torch.where(valid_slot[:, None], a.values[sl], 0)
    valid = ks < a.ncols
    bcols, bvals = _gather_b_rows(b, torch.where(valid, ks, b.nrows),
                                  max_row_b)
    prod = bvals[:, :, None] * slab[:, None, :]           # (S, W, K)
    # one K-row window per (slot, B-column): rows base..base+K-1
    base = torch.clamp(a.row_base.long()[cl], 0, a.nrows)
    kk = torch.arange(a.max_cluster, dtype=torch.int64, device=c.device)
    rows = base[:, None, None] + kk                        # (S, 1, K)
    cols = torch.clamp(bcols, max=b.ncols)[:, :, None]     # (S, W, 1)
    c.index_put_((rows.expand(prod.shape), cols.expand(prod.shape)), prod,
                 accumulate=True)


def spgemm_clusterwise_dense_binned(a: CSRCluster, b: CSR,
                                    bins: list[tuple[np.ndarray, int]],
                                    slot_clusters: np.ndarray | None = None
                                    ) -> torch.Tensor:
    """Cluster-wise SpGEMM (Alg. 1) with per-bin gather widths: one B-row
    gather per (cluster, column) slot, applied to *all* rows of the
    cluster via an outer product with the value slab. Returns dense C.

    ``slot_clusters`` — optional precomputed slot→cluster map
    (:func:`slot_rows_host` over ``cluster_ptr``).
    """
    dev = a.values.device
    if slot_clusters is None:
        sc = _slot_rows(a.cluster_ptr, a.slot_cap)
    else:
        sc = torch.as_tensor(slot_clusters, device=dev).long()
    c = torch.zeros((a.nrows + a.max_cluster, b.ncols + 1),
                    dtype=a.values.dtype, device=dev)
    for slots, w in bins:
        _clusterwise_pass(a, b, torch.as_tensor(slots, device=dev).long(),
                          c, sc, w)
    return c[: a.nrows, : b.ncols]


# ---------------------------------------------------------------------------
# sparse × dense tall-skinny (paper §4.4)
# ---------------------------------------------------------------------------


def spmm_rowwise(a: CSR, bdense: torch.Tensor) -> torch.Tensor:
    """Row-wise CSR × dense: one gather of B[k, :] per nonzero of A."""
    rows = _slot_rows(a.indptr, a.nnz_cap)
    ks = a.indices.long()
    valid = ks < a.ncols
    brows = bdense[torch.where(valid, ks, 0)]              # (nnz_a, N)
    prod = torch.where(valid, a.data, 0)[:, None] * brows
    c = torch.zeros((a.nrows, bdense.shape[1]), dtype=prod.dtype,
                    device=prod.device)
    return c.index_add_(0, torch.clamp(rows, 0, a.nrows - 1), prod)


def spmm_clusterwise(a: CSRCluster, bdense: torch.Tensor) -> torch.Tensor:
    """Cluster-wise CSR_Cluster × dense: one gather per (cluster, column)."""
    cl = torch.clamp(_slot_rows(a.cluster_ptr, a.slot_cap), 0,
                     a.nclusters - 1)
    ks = a.cols.long()
    valid = ks < a.ncols
    brows = bdense[torch.where(valid, ks, 0)]              # (S, N)
    brows = torch.where(valid[:, None], brows, 0)
    prod = a.values[:, :, None] * brows[:, None, :]        # (S, K, N)
    base = a.row_base.long()[cl]
    kk = torch.arange(a.max_cluster, dtype=torch.int64, device=prod.device)
    out_rows = torch.clamp(base[:, None] + kk[None, :], 0, a.nrows)  # (S, K)
    c = torch.zeros((a.nrows + 1, bdense.shape[1]), dtype=prod.dtype,
                    device=prod.device)
    c.index_add_(0, out_rows.reshape(-1), prod.reshape(-1, bdense.shape[1]))
    return c[: a.nrows]


# ---------------------------------------------------------------------------
# oracle + metrics
# ---------------------------------------------------------------------------


def spgemm_reference(a: HostCSR, b: HostCSR) -> np.ndarray:
    """Pure-numpy oracle: densify and matmul."""
    return a.to_dense() @ b.to_dense()


def symbolic_nnz(a: HostCSR, b: HostCSR) -> int:
    """Symbolic-phase nnz(C) (exact, host-side, whole-matrix scalar): the
    oracle :func:`repro_torch.core.formats.symbolic_strip_nnz`'s per-strip
    bounds are held against."""
    c = (a.to_dense() != 0).astype(np.float32) @ \
        (b.to_dense() != 0).astype(np.float32)
    return int((c != 0).sum())


def symbolic_row_nnz(a: HostCSR, b: HostCSR) -> np.ndarray:
    """Exact per-row nnz(C) (structural — cancellation ignored): every row
    block's ``symbolic_strip_nnz`` bound must dominate each of its rows."""
    c = (a.to_dense() != 0).astype(np.float32) @ \
        (b.to_dense() != 0).astype(np.float32)
    return (c != 0).sum(axis=1).astype(np.int64)


def flops_spgemm(a: HostCSR, b: HostCSR) -> int:
    """2 × Σ_{a_ik ≠ 0} nnz(B row k) — the standard SpGEMM flop count."""
    bn = b.row_nnz()
    return int(2 * bn[a.indices.astype(np.int64)].sum())


def gathers_rowwise(a: HostCSR) -> int:
    """Number of B-row fetches the row-wise dataflow performs."""
    return a.nnz


def gathers_clusterwise(nslots: int) -> int:
    """Number of B-row fetches the cluster-wise dataflow performs
    (= deduplicated (cluster, column) slots)."""
    return nslots


def b_bytes_rowwise_binned(bins: list[tuple[np.ndarray, int]],
                           nslots: int) -> int:
    """B bytes the binned gather passes move per A² call: every live slot
    fetches its B row padded to the bin width — 8 B (int32 index + fp32
    value) per fetched element, re-fetched per A nonzero (no cross-row
    reuse)."""
    total = 0
    for slots, w in bins:
        total += int((np.asarray(slots) < nslots).sum()) * w * 8
    return total


def b_bytes_tiled(nlive_tiles: int, block_k: int = 128,
                  bn: int = 128) -> int:
    """B bytes the tiled Sp×Sp kernels move per A² call: each live dense
    fp32 tile (4 B/slot, no indices) is read once and reused by every
    cluster slab that touches it."""
    return nlive_tiles * block_k * bn * 4
