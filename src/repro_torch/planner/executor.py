"""The executor: a plan's packed device operands, their packs, and the
cache that keeps them.

A packed operand is one frozen type per route; its ``run(bd)`` launches
the product on the device from it and a dense B (``None`` for a sparse
B). Where a route has a rowwise and a clusterwise variant, the operand's
own format picks one. The packs build operands under the ``pack`` span;
:class:`ExecCache` keeps them per (plan, operand values).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.formats import (CSR, CSRCluster, HostCSR, TiledCSR,
                                      ValueLayout, bcc_from_host,
                                      csr_cluster_from_host,
                                      csr_cluster_layout, csr_from_host,
                                      csr_layout, fill_values,
                                      select_block_k, tiled_csr_from_host)
from repro_torch.core.spgemm import (length_bins, slot_rows_host,
                                     spgemm_clusterwise_dense_binned,
                                     spgemm_rowwise_dense_binned,
                                     spmm_clusterwise, spmm_rowwise)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.plan_cache import Plan
from repro_torch.resilience import faults as _faults

__all__ = ["GatherSpMM", "KernelSpMM", "GatherSpGEMM", "KernelSpGEMM",
           "ExecCache", "pack_dense_b", "pack_sparse_b", "count_product",
           "tensor_nbytes"]


@dataclasses.dataclass(frozen=True, eq=False)
class GatherSpMM:
    """A, for a dense B on the gather tier."""

    op: CSR | CSRCluster

    def run(self, bd: torch.Tensor) -> torch.Tensor:
        if isinstance(self.op, CSRCluster):
            return spmm_clusterwise(self.op, bd)
        return spmm_rowwise(self.op, bd)


@dataclasses.dataclass(frozen=True, eq=False)
class KernelSpMM:
    """A's compact BCC stream and its slabs' live columns, for a dense B
    through K4 (which reads nothing else of the padded BCC)."""

    nrows: int
    stream: tuple
    cols: kernel_ops.SlabColumns

    def run(self, bd: torch.Tensor) -> torch.Tensor:
        return kernel_ops.spmm_compact_stream(self.stream, bd,
                                              nrows=self.nrows,
                                              cols=self.cols)


@dataclasses.dataclass(frozen=True, eq=False)
class GatherSpGEMM:
    """A and a sparse B with the gather tier's length bins (``slots``:
    each slot's row of A, or cluster)."""

    op_a: CSR | CSRCluster
    op_b: CSR
    bins: list
    slots: np.ndarray

    def run(self, bd: None = None) -> torch.Tensor:
        if isinstance(self.op_a, CSRCluster):
            return spgemm_clusterwise_dense_binned(self.op_a, self.op_b,
                                                   self.bins, self.slots)
        return spgemm_rowwise_dense_binned(self.op_a, self.op_b, self.bins,
                                           self.slots)


@dataclasses.dataclass(frozen=True, eq=False)
class KernelSpGEMM:
    """B's tiles and the launch's pack (all it reads of A), for a sparse
    B through the kernel tier."""

    tiled: TiledCSR
    pack: kernel_ops.SpGEMMPack

    def run(self, bd: None = None, *, compacted: bool = False):
        """C dense (a sparse-C pack densifies it), or with ``compacted``
        a sparse-C pack's ``CompactedC``, as a chain hop takes it."""
        if compacted:
            return kernel_ops.bcc_spgemm_sparse_c(None, self.tiled,
                                                  pack=self.pack)
        return kernel_ops.bcc_spgemm_tiled(None, self.tiled, pack=self.pack)


def apply_plan_perm(a: HostCSR, plan: Plan, *, symmetric: bool) -> HostCSR:
    if plan.perm is None:
        return a
    if symmetric and a.nrows == a.ncols:
        return a.permute_symmetric(plan.perm)
    return a.permute_rows(plan.perm)


def plan_bounds(plan: Plan) -> list[int]:
    if plan.boundaries is None:
        raise ValueError(f"plan scheme {plan.scheme} has no boundaries")
    return np.asarray(plan.boundaries, dtype=np.int64).tolist()


def count_product(plan: Plan) -> None:
    """Count one executed product under its plan's tier:
    ``kernel_tier_products`` for the ``pallas`` scheme (the hand-written
    kernels), ``gather_tier_products`` for the other four."""
    tier = "kernel" if plan.scheme == "pallas" else "gather"
    obs_metrics.get_registry().counter(f"{tier}_tier_products").inc()


def _pack_span(plan: Plan, kind: str):
    return get_tracer().span("pack", fingerprint=plan.fingerprint,
                             scheme=plan.scheme, kind=kind)


def pack_dense_b(plan: Plan, a: HostCSR, *, cache: ExecCache,
                 pattern_key: str,
                 device: torch.device) -> GatherSpMM | KernelSpMM:
    """A's operand for a dense B. The gather tier fills the layout of
    A's pattern, which ``cache`` keeps under ``pattern_key`` (every values
    array of the pattern shares it)."""
    with _pack_span(plan, "dense_b") as sp:
        _faults.maybe_fault("pack")
        if plan.scheme == "pallas":
            ap = apply_plan_perm(a, plan, symmetric=False)
            stream = kernel_ops.bcc_compact_stream(
                bcc_from_host(ap, device=device), cover_all_blocks=True)
            return KernelSpMM(ap.nrows, stream,
                              kernel_ops.slab_columns(stream[2]))

        def build() -> ValueLayout:
            if plan.scheme == "rowwise":
                return csr_layout(a, perm=plan.perm, device=device)
            return csr_cluster_layout(a, plan_bounds(plan),
                                      max_cluster=plan.max_cluster,
                                      perm=plan.perm, device=device)
        layout, hit = cache.layout(f"{pattern_key}|layout", a.nnz, build)
        sp.set(layout_hit=hit)
        return GatherSpMM(fill_values(layout, a.data))


def pack_sparse_b(plan: Plan, a: HostCSR, b: Optional[HostCSR], *,
                  device: torch.device, b_dtype: torch.dtype,
                  sparse_c: bool = False
                  ) -> GatherSpGEMM | KernelSpGEMM | None:
    """The operands of ``A @ B`` for a sparse B (``b=None``: A², permuted
    symmetrically). ``sparse_c`` packs a chain hop's kernel-tier operands
    for the sparse-C route, or returns ``None`` where its live-pair grid
    does not apply (:func:`~repro_torch.kernels.ops.compact_grid_ok`)."""
    squared = b is None
    with _pack_span(plan, "sparse_c" if sparse_c else
                    "sq" if squared else "ab"):
        _faults.maybe_fault("pack")
        ap = apply_plan_perm(a, plan, symmetric=squared)
        bh = ap if squared else b
        if plan.scheme == "pallas":
            # the adaptive k-tile height, the compact A stream, the route
            # (live-pair grid, or the padded grid for wide B) and its
            # device launch, packed once per cached operand pair
            bk = select_block_k(bh)
            tiled = tiled_csr_from_host(bh, block_k=bk, dtype=b_dtype,
                                        device=device)
            bcc = bcc_from_host(ap, block_k=bk, device=device)
            if sparse_c and not kernel_ops.compact_grid_ok(bcc, tiled,
                                                           sparse_c=True):
                return None
            return KernelSpGEMM(tiled, kernel_ops.pack_spgemm(
                bcc, tiled, sparse_c=sparse_c or None))
        dev_b = csr_from_host(bh, device=device)
        b_lens = bh.row_nnz()
        if plan.scheme == "rowwise":
            dev_a = csr_from_host(ap, device=device)
            fetch = np.zeros(dev_a.nnz_cap, dtype=np.int64)
            fetch[: ap.nnz] = b_lens[ap.indices.astype(np.int64)]
            bins = length_bins(fetch, pad_sentinel=dev_a.nnz_cap)
            return GatherSpGEMM(dev_a, dev_b, bins,
                                slot_rows_host(ap.indptr, dev_a.nnz_cap))
        cc = csr_cluster_from_host(ap, plan_bounds(plan),
                                   max_cluster=plan.max_cluster,
                                   device=device)
        cptr = cc.cluster_ptr.cpu().numpy()
        total = int(cptr[-1])
        slot_cols = cc.cols.cpu().numpy()[:total].astype(np.int64)
        fetch = np.zeros(cc.slot_cap, dtype=np.int64)
        fetch[:total] = np.where(slot_cols < bh.nrows, b_lens[
            np.clip(slot_cols, 0, bh.nrows - 1)], 0)
        bins = length_bins(fetch, pad_sentinel=cc.slot_cap)
        return GatherSpGEMM(cc, dev_b, bins,
                            slot_rows_host(cptr, cc.slot_cap))


def tensor_nbytes(obj) -> int:
    """Bytes of the tensors an exec-cache entry holds (walking tuples,
    lists and dataclasses; host numpy arrays and scalars count 0)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tensor_nbytes(x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensor_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


class ExecCache:
    """Packed operands by key, capped by entry count (``cap``) and by the
    tensor bytes held (``bytes_cap``: a quarter of the card, or 4 GiB of
    host memory on the CPU): fresh-valued traffic adds an entry per
    request. The oldest entries go first; an entry over the byte cap is
    not kept. A dense-B gather-tier pack's :class:`ValueLayout` lives here
    too, under its pattern's key; the per-value entries that share its
    tensors count their bytes again. Worker threads share one cache."""

    def __init__(self, device: torch.device):
        self.cap = 64
        self.bytes_cap = (
            torch.cuda.get_device_properties(device).total_memory // 4
            if device.type == "cuda" else 4 * 2**30)
        self._entries: dict[str, tuple[object, int]] = {}
        self._lock = threading.Lock()

    def operand(self, key: str, pack: Callable[[], object]):
        """The entry under ``key`` (counted in ``exec_cache_hits``), else
        ``pack()``'s, kept and counted in ``exec_cache_packs`` and the
        entry and byte gauges (a ``None`` from ``pack`` is returned)."""
        with self._lock:
            packed = self._entries.get(key, (None, 0))[0]
        reg = obs_metrics.get_registry()
        if packed is not None:
            reg.counter("exec_cache_hits").inc()
            return packed
        packed = pack()
        if packed is not None:
            self._keep(key, packed)
            reg.counter("exec_cache_packs").inc()
            with self._lock:
                entries, nbytes = len(self._entries), self._nbytes_locked()
            reg.gauge("exec_cache_entries").set(entries)
            reg.gauge("exec_cache_bytes").set(nbytes)
        return packed

    def layout(self, key: str, nnz: int,
               build: Callable[[], ValueLayout]) -> tuple[ValueLayout, bool]:
        """The layout under ``key`` and ``True``, else ``build()``'s, kept,
        and ``False``. A find counts in ``pack_layout_hits`` and moves to
        the newest end, ahead of the per-value entries it outlives."""
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._entries[key] = entry
        if entry is not None and entry[0].nnz == nnz:
            obs_metrics.get_registry().counter("pack_layout_hits").inc()
            return entry[0], True
        layout = build()
        self._keep(key, layout)
        return layout, False

    def _keep(self, key: str, obj) -> None:
        nbytes = tensor_nbytes(obj)
        if nbytes > self.bytes_cap:
            return
        with self._lock:
            while self._entries and (
                    len(self._entries) >= self.cap
                    or self._nbytes_locked() + nbytes > self.bytes_cap):
                self._entries.pop(next(iter(self._entries)))
            self._entries[key] = (obj, nbytes)

    def _nbytes_locked(self) -> int:
        return sum(n for _, n in self._entries.values())

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def items(self) -> list[tuple[str, object]]:
        """``(key, entry)`` pairs, oldest first."""
        with self._lock:
            return [(k, v) for k, (v, _) in self._entries.items()]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
