"""Shared measurement machinery: the paper's sweep (reordering × clustering
scheme → A² time, preprocessing cost and format bytes) on the port's
binned gather/scatter passes.

Design notes (as in the JAX package's ``benchlib``):

* **Shape bucketing** — matrices are zero-padded so (nrows, nnz_cap) land
  on power-of-two buckets. Padding rows are empty: they contribute
  nothing to A² and nothing to the timings' comparative structure.
* **Result caching** — every (matrix, reorder, scheme) measurement is
  memoized in-process and persisted to ``experiments/bench_cache_torch.json``
  (the port's own file). Each key ends with the generation tag of the
  device that measured (:func:`kernel_gen`: ``"torch1-cuda"``,
  ``"torch1-cpu"``), so no CPU timing reaches a fit made for the card,
  and no card timing a fit made for the CPU.
* **What "speedup" means here** — wall time of the port's binned passes
  (``index_put_`` scatters) on the device named, synchronized: the same
  dataflow the paper implements in C++/OpenMP, on the card's memory
  system instead of a Xeon's caches.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.clustering import (Clustering, fixed_length_clusters,
                                         hierarchical_clusters,
                                         variable_length_clusters)
from repro_torch.core.formats import (HostCSR, csr_cluster_from_host,
                                      csr_cluster_nbytes_exact,
                                      csr_from_host, csr_nbytes)
from repro_torch.core.reorder import reorder
from repro_torch.core.spgemm import (flops_spgemm, length_bins,
                                     slot_rows_host,
                                     spgemm_clusterwise_dense_binned,
                                     spgemm_rowwise_dense_binned,
                                     spmm_clusterwise, spmm_rowwise)
from repro_torch.core.suite import SUITE, MatrixSpec
from repro_torch.device import resolve_device

__all__ = ["BenchResult", "bench_rowwise_on", "bench_clusterwise_on",
           "bench_tallskinny_on", "representative_subset", "save_cache",
           "load_cache", "CACHE_PATH", "kernel_gen", "time_fn",
           "time_host_fn", "pad_host"]

CACHE_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
                          "experiments", "bench_cache_torch.json")

_CACHE: dict[str, dict] = {}


def _bucket(x: int, floor: int = 8) -> int:
    n = max(x, floor)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class BenchResult:
    kernel_s: float
    preprocess_s: float
    nnz: int
    flops: int
    mem_bytes: int
    nclusters: int = 0

    def to_json(self):
        return dataclasses.asdict(self)


def _sync(out) -> None:
    """Wait for the card that holds any tensor of ``out`` (a tensor, or a
    tuple or list of them); nothing to wait for on the CPU."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _sync(o)


def time_fn(fn: Callable, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best-of-``reps`` wall time of ``fn(*args)`` after ``warmup`` calls.

    Launches are asynchronous: the device of the tensors ``fn`` returns is
    synchronized before each timed call (the previous call's work is
    drained) and after it (the call's own work is inside the time). On the
    CPU the calls are simply timed."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _sync(out)
    best = float("inf")
    for _ in range(reps):
        _sync(out)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best


def time_host_fn(fn: Callable, *args, reps: int = 3, warmup: int = 1,
                 **kwargs) -> float:
    """Best-of-``reps`` wall time of a *host-side* (numpy) function — the
    preprocessing analogue of :func:`time_fn` (no device sync needed)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return best


def pad_host(a: HostCSR, nrows: int) -> HostCSR:
    """Zero-pad to (nrows, nrows) — padding rows/cols are empty."""
    if nrows == a.nrows:
        return a
    indptr = np.concatenate([
        a.indptr, np.full(nrows - a.nrows, a.indptr[-1], np.int64)])
    return HostCSR(indptr, a.indices, a.data, (nrows, nrows))


# bump when the measured passes change so stale caches can't serve
# timings of another generation; the device type is appended per key
_KERNEL_GEN = "torch1"


def kernel_gen(device) -> str:
    """The generation tag of measurements taken on ``device``."""
    return f"{_KERNEL_GEN}-{torch.device(device).type}"


def _key(spec_name: str, algo: str, scheme: str, workload: str,
         device: torch.device) -> str:
    return f"{spec_name}|{algo}|{scheme}|{workload}|{kernel_gen(device)}"


def load_cache() -> None:
    global _CACHE
    if os.path.exists(CACHE_PATH):
        with open(CACHE_PATH) as f:
            _CACHE = json.load(f)


def save_cache() -> None:
    os.makedirs(os.path.dirname(CACHE_PATH), exist_ok=True)
    with open(CACHE_PATH, "w") as f:
        json.dump(_CACHE, f)


def _cached(key: str, make: Callable[[], BenchResult]) -> BenchResult:
    if key in _CACHE:
        return BenchResult(**_CACHE[key])
    res = make()
    _CACHE[key] = res.to_json()
    return res


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------


def _prep_reorder(a: HostCSR, algo: str) -> tuple[HostCSR, float]:
    t0 = time.perf_counter()
    b, _ = reorder(a, algo)
    return b, time.perf_counter() - t0


def bench_rowwise_on(a: HostCSR, algo: str, *, name: str = "",
                     reps: int = 3, device="cuda",
                     check: Callable | None = None) -> BenchResult:
    """Reorder (algo) → row-wise A² on the binned passes, on ``device``.

    ``check(b, c)``, when given, is called on a measurement (not on a
    cache hit) with the reordered operand ``b`` and the timed call's
    product ``c`` (dense, on ``device``, padded to the shape bucket)."""
    dev = resolve_device(device)

    def make() -> BenchResult:
        b, t_pre = _prep_reorder(a, algo)
        n = _bucket(b.nrows)
        bp = pad_host(b, n)
        csr = csr_from_host(bp, nnz_cap=_bucket(bp.nnz), device=dev)
        # skew-aware slot binning: each nonzero pays the gather/scatter
        # width of the B row it actually fetches, not the global max
        bins = length_bins(bp.row_nnz()[bp.indices],
                           pad_sentinel=csr.nnz_cap)
        srows = slot_rows_host(csr.indptr.cpu().numpy(), csr.nnz_cap)

        def run():
            return spgemm_rowwise_dense_binned(csr, csr, bins, srows)
        t = time_fn(run, reps=reps)
        if check is not None:
            check(b, run())
        return BenchResult(kernel_s=t, preprocess_s=t_pre, nnz=b.nnz,
                           flops=flops_spgemm(b, b), mem_bytes=csr_nbytes(b))
    return _cached(_key(name or id(a), algo, "rowwise", "a2", dev), make)


def _make_clustering(a: HostCSR, scheme: str) -> tuple[HostCSR, Clustering,
                                                       float]:
    t0 = time.perf_counter()
    if scheme == "fixed":
        cl = fixed_length_clusters(a, 8)
        ar = a
    elif scheme == "variable":
        cl = variable_length_clusters(a)
        ar = a
    elif scheme == "hierarchical":
        cl = hierarchical_clusters(a)
        ar = a.permute_symmetric(cl.perm)
    else:
        raise ValueError(scheme)
    return ar, cl, time.perf_counter() - t0


def bench_clusterwise_on(a: HostCSR, algo: str, scheme: str, *,
                         name: str = "", reps: int = 3, device="cuda",
                         check: Callable | None = None) -> BenchResult:
    """Reorder (algo) → cluster (scheme) → cluster-wise A² on ``device``;
    ``check`` as in :func:`bench_rowwise_on` (the operand is the
    clustered one: ``hierarchical`` permutes it again)."""
    dev = resolve_device(device)

    def make() -> BenchResult:
        b, t_reord = _prep_reorder(a, algo)
        ar, cl, t_cl = _make_clustering(b, scheme)
        n = _bucket(ar.nrows)
        arp = pad_host(ar, n)
        bounds = cl.boundaries.tolist()
        # pad clusters to cover padding rows (single trailing run)
        extra = list(range(ar.nrows, n, cl.max_cluster))
        cc = csr_cluster_from_host(arp, bounds + extra,
                                   max_cluster=cl.max_cluster,
                                   slot_cap=_bucket(arp.nnz + len(extra)),
                                   device=dev)
        dev_b = csr_from_host(arp, nnz_cap=_bucket(arp.nnz), device=dev)
        cptr = cc.cluster_ptr.cpu().numpy()
        total = int(cptr[-1])
        slot_cols = cc.cols[:total].cpu().numpy().astype(np.int64)
        row_len = arp.row_nnz()
        lens = np.where(slot_cols < arp.ncols,
                        row_len[np.clip(slot_cols, 0, arp.nrows - 1)], 0)
        bins = length_bins(lens, pad_sentinel=cc.slot_cap)
        sclust = slot_rows_host(cptr, cc.slot_cap)

        def run():
            return spgemm_clusterwise_dense_binned(cc, dev_b, bins, sclust)
        t = time_fn(run, reps=reps)
        if check is not None:
            check(ar, run())
        mem = csr_cluster_nbytes_exact(ar, bounds,
                                       fixed_length=(scheme == "fixed"))
        return BenchResult(kernel_s=t, preprocess_s=t_reord + t_cl,
                           nnz=ar.nnz, flops=flops_spgemm(ar, ar),
                           mem_bytes=mem, nclusters=cl.nclusters)
    return _cached(_key(name or id(a), algo, scheme, "a2", dev), make)


def bench_tallskinny_on(a: HostCSR, algo: str, scheme: str, *,
                        name: str = "", width: int = 64, frontier_seed: int = 0,
                        reps: int = 3, device="cuda") -> BenchResult:
    """Square × tall-skinny (paper §4.4): B is a dense (n, width) frontier
    block (BFS-frontier-like sparsity folded densely)."""
    dev = resolve_device(device)

    def make() -> BenchResult:
        b, t_reord = _prep_reorder(a, algo)
        rng = np.random.default_rng(frontier_seed)
        frontier = (rng.random((a.ncols, width)) < 0.05).astype(np.float32)
        if scheme == "rowwise":
            n = _bucket(b.nrows)
            bp = pad_host(b, n)
            csr = csr_from_host(bp, nnz_cap=_bucket(bp.nnz), device=dev)
            frp = _pad_rows(frontier, n, dev)
            t = time_fn(lambda: spmm_rowwise(csr, frp), reps=reps)
            return BenchResult(kernel_s=t, preprocess_s=t_reord, nnz=b.nnz,
                               flops=2 * b.nnz * width,
                               mem_bytes=csr_nbytes(b))
        ar, cl, t_cl = _make_clustering(b, scheme)
        n = _bucket(ar.nrows)
        arp = pad_host(ar, n)
        extra = list(range(ar.nrows, n, cl.max_cluster))
        cc = csr_cluster_from_host(arp, cl.boundaries.tolist() + extra,
                                   max_cluster=cl.max_cluster,
                                   slot_cap=_bucket(arp.nnz + len(extra)),
                                   device=dev)
        frp = _pad_rows(frontier, n, dev)
        t = time_fn(lambda: spmm_clusterwise(cc, frp), reps=reps)
        return BenchResult(kernel_s=t, preprocess_s=t_reord + t_cl,
                           nnz=ar.nnz, flops=2 * ar.nnz * width,
                           mem_bytes=0, nclusters=cl.nclusters)
    return _cached(_key(name or id(a), algo, scheme,
                        f"ts{width}_{frontier_seed}", dev), make)


def _pad_rows(x: np.ndarray, nrows: int, device) -> torch.Tensor:
    """``x`` zero-padded to ``nrows`` rows, as a tensor on ``device``."""
    out = np.zeros((nrows, x.shape[1]), dtype=x.dtype)
    out[: x.shape[0]] = x
    return torch.from_numpy(out).to(device)


# ---------------------------------------------------------------------------
# suite subsets
# ---------------------------------------------------------------------------


def representative_subset(limit: int = 24,
                          seed: int = 0) -> list[MatrixSpec]:
    """Family-stratified subset: round-robin one spec per family, preferring
    scrambled variants (where reordering has something to recover)."""
    by_family: dict[str, list[MatrixSpec]] = {}
    for s in SUITE:
        by_family.setdefault(s.family, []).append(s)
    for fam in by_family:
        by_family[fam].sort(key=lambda s: (not s.scrambled, s.name))
    out: list[MatrixSpec] = []
    idx = 0
    while len(out) < min(limit, len(SUITE)):
        advanced = False
        for fam in sorted(by_family):
            lst = by_family[fam]
            if idx < len(lst):
                out.append(lst[idx])
                advanced = True
                if len(out) >= limit:
                    break
        if not advanced:
            break
        idx += 1
    return out[:limit]
