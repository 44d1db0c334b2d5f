#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root with one CUDA card visible::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. environment — the card's name and power limit, the CUDA version, the
   SM count, and the build of every kernel source with nvcc (one process
   per source, all started together, into ``build/repro_torch/``);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it: integer-valued operands compare
   exactly (``torch.equal``); each case prints its time (CUDA events,
   median of 5 — 3 for slow cases — after a warm-up), the plain
   version's, the bound (from the work the product needs: true flops, CSR
   operands read once, the result written once), the bound of the
   kernel's tile-padded work beside it, and one PyTorch library call
   timed as a yardstick the port never calls. The kernels: the window
   kernel (kron-14 dense strips, caveman-16384 slabs, a block_k = 512
   case, bf16 tiles), the compact SpMM kernel, the padded-grid kernel on
   a wide A·B (the first 8,192 rows of a 288 × 288 mesh times the mesh:
   82,944 columns, past the live-pair grid's strip budget; fp32 and bf16
   tiles), the revisit kernel and the sharded kernel (kron-14 with 1 and
   SM-count shards, caveman-16384 with 1, 8 and SM-count shards, with and
   without the revisit order — each also equal to the window kernel's
   strips);
3. the serving path — ``SpGEMMServer.submit`` with pallas plans seeded in
   the plan cache: kron-14 A² on the dense-strip route and caveman-16384
   A² reordered by RCM on the sparse-C route (two fresh-valued requests
   and one repeat each), one kron-14 × dense-B SpMM, the wide A·B on the
   padded grid (fresh, then a repeat), a ``hops=2`` chain on caveman with
   both hops on the sparse-C route, and a chaos request (a fault armed at
   ``kernel_launch`` on a kron-14 request of a server with its own
   resilience policy) that must degrade to the ``fixed`` rung, after which
   the next request must plan around the quarantined plan. Every launch
   counter is zeroed just before and read just after; every result must
   equal scipy's product exactly; no request but the chaos one may
   degrade; each request's ``execute_s`` is split by profiler device time
   and by tracing spans; then one unseeded request in measured mode, whose
   choice is printed, not asserted. Phase 3b drives
   ``bcc_spgemm_tiled(shards=…, revisit=…)`` on kron-14 the same way
   (the revisit kernel once, the sharded kernel twice);
4. summary — one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line,
   and last ``{"ok": true, "device": {...}}``.

``--rehearse`` runs the same phases on the CPU at small sizes through the
plain versions (no launch counts, no timings) and exits 2 without the
final line: a dry run of the control flow before a card is used
(``tests/test_torch_smoke.py`` runs it).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet peaks (dense): fp32 on the CUDA cores, HBM3 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def integer_valued(h, rng):
    """Same pattern, fresh values in {1, 2, 3}: fp32 sums stay exact."""
    from repro_torch.core.formats import HostCSR
    return HostCSR(h.indptr, h.indices,
                   rng.integers(1, 4, h.nnz).astype(np.float32), h.shape)


def timed_ms(fn, device, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up (on the
    CPU, host wall time)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        else:
            s = time.perf_counter()
            fn()
            times.append((time.perf_counter() - s) * 1e3)
    return statistics.median(times)


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def csr_bytes(nrows: int, nnz: int) -> int:
    """A CSR matrix read or written once: int32 row offsets and column
    indices, fp32 values."""
    return 4 * (nrows + 1) + 8 * nnz


def scipy_csr(h):
    import scipy.sparse as sp
    return sp.csr_matrix((h.data, h.indices, h.indptr), shape=h.shape)


def torch_csr(h, device):
    import torch
    with warnings.catch_warnings():       # "CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(h.indptr), torch.from_numpy(
                h.indices.astype(np.int64)), torch.from_numpy(h.data),
            size=h.shape, device=device, check_invariants=False)


def library_ms(fn, device):
    """Time one PyTorch library call (cuSPARSE behind torch.sparse.mm);
    None with the reason printed when this build does not support it."""
    try:
        return timed_ms(fn, device)
    except (RuntimeError, NotImplementedError) as e:
        log(f"    library call unavailable: {type(e).__name__}: {e}")
        return None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def window_case(name, h, device, *, sparse_c, b_dtype=None, windows=None,
                tol=None, timing=True):
    """One window-kernel case at the packing the serving path builds."""
    import torch
    from repro_torch.core.formats import (bcc_from_host, select_block_k,
                                          tiled_csr_from_host)
    from repro_torch.core.spgemm import flops_spgemm
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spgemm import (
        cluster_spgemm_windows, cluster_spgemm_windows_plain)
    launches0 = cluster_spgemm_windows.launches
    bk = select_block_k(h)
    bcc = bcc_from_host(h, block_k=bk, device=device)
    tiled = tiled_csr_from_host(h, block_k=bk, device=device,
                                dtype=b_dtype or torch.float32)
    if windows is None:
        pack = ops.pack_spgemm(bcc, tiled, sparse_c=sparse_c)
        windows, a_vals = pack.launch, pack.stream[2]
    else:
        a_vals = ops.bcc_compact_stream(bcc, cover_all_blocks=True)[2]
    del bcc
    run = lambda: cluster_spgemm_windows(windows, a_vals,  # noqa: E731
                                         tiled.tiles)
    plain = lambda: cluster_spgemm_windows_plain(  # noqa: E731
        windows, a_vals, tiled.tiles)
    got, want = run(), plain()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if tol is None:
        ok = bool(torch.equal(got, want))
        tol_txt = "exact (torch.equal)"
    else:
        ok = err <= tol * max(float(want.abs().max()), 1e-30)
        tol_txt = f"max|kernel-plain| <= {tol:g} x max|plain|"
    ms = timed_ms(run, device) if timing else None
    plain_ms = timed_ms(plain, device) if timing else None
    # the bound: what A @ A needs — its true flops, the CSR operand read
    # once, the result written once (dense C on the dense route; on the
    # slab route C's nonzeros, as CSR)
    true_flops = flops_spgemm(h, h)
    if sparse_c:
        hs = scipy_csr(h)
        nnz_c = (hs @ hs).nnz
        out_bytes = csr_bytes(h.nrows, nnz_c)
    else:
        nnz_c = None
        out_bytes = 4 * h.nrows * h.ncols
    bound_ms, bound_by = bound(csr_bytes(h.nrows, h.nnz) + out_bytes,
                               true_flops)
    # the kernel's own tile-padded work, printed beside it
    tile_flops = 2 * windows.npairs * windows.block_r * bk * windows.bn
    a_bytes = a_vals.numel() * 4
    b_bytes = tiled.tiles.numel() * tiled.tiles.element_size()
    tile_bytes = (a_bytes + b_bytes + got.numel() * 4
                  + 4 * (windows.nwin + 1) + 8 * windows.nwin
                  + 8 * windows.npairs)
    tile_bound_ms, tile_bound_by = bound(tile_bytes, tile_flops)
    hc = torch_csr(h, device)
    lib = (lambda: torch.sparse.mm(hc, hc)) if sparse_c else (
        lambda: torch.sparse.mm(hc, hc).to_dense())
    lib_ms = library_ms(lib, device) if timing else None
    case = {"case": name, "rows": h.nrows, "nnz": h.nnz, "block_k": bk,
            "b_dtype": str(tiled.tiles.dtype).replace("torch.", ""),
            "output": "CompactedC slabs" if sparse_c else "dense strips",
            "out_shape": list(windows.out_shape), "windows": windows.nwin,
            "pairs": windows.npairs, "true_flops": true_flops,
            "nnz_c": nnz_c, "tile_flops": tile_flops,
            "a_stream_bytes": a_bytes, "b_tile_bytes": b_bytes,
            "out_bytes": got.numel() * 4,
            "max_abs_err": err, "tolerance": tol_txt, "matched": ok,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR A once + result once (dense C, "
                           "or C's nonzeros as CSR on the slab route) / "
                           "3.35 TB/s, true flops (flops_spgemm) / "
                           "67 TFLOP/s fp32)"),
            "tile_bound_ms": tile_bound_ms, "tile_bound_by": tile_bound_by,
            "tile_bound_rule": ("max(bytes: A stream + B tiles + output + "
                                "index arrays once / 3.35 TB/s, tile fp32 "
                                "FMAs 2*pairs*8*block_k*bn / 67 TFLOP/s)"),
            "library": "torch.sparse.mm(csr, csr)"
                       + ("" if sparse_c else ".to_dense()"),
            "library_ms": lib_ms,
            "compare_launches": cluster_spgemm_windows.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"window kernel disagrees with its plain version "
                         f"on {name}: max abs err {err}")
    return case, windows, got


def spmm_case(name, h, n_cols, device, rng, *, timing=True):
    import torch
    from repro_torch.core.formats import bcc_from_host
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spmm import (
        KERNEL_MAX_BN, cluster_spmm_compact, cluster_spmm_compact_plain)
    launches0 = cluster_spmm_compact.launches
    bcc = bcc_from_host(h, device=device)
    block_ids, tile_ids, a_vals = ops.bcc_compact_stream(
        bcc, cover_all_blocks=True)
    nblocks = bcc.nblocks
    b = torch.from_numpy(rng.integers(1, 4, (h.ncols, n_cols)).astype(
        np.float32)).to(device)
    bids = torch.from_numpy(block_ids).to(device)
    tids = torch.from_numpy(tile_ids).to(device)
    kw = dict(block_r=bcc.block_r, block_k=bcc.block_k, nblocks=nblocks)
    bn = min(KERNEL_MAX_BN, n_cols)
    run = lambda: cluster_spmm_compact(bids, tids, a_vals, b,  # noqa: E731
                                       bn=bn, **kw)
    plain = lambda: cluster_spmm_compact_plain(  # noqa: E731
        bids, tids, a_vals, b, **kw)
    got, want = run(), plain()
    err = float((got - want).abs().max())
    ok = bool(torch.equal(got, want))
    ms = timed_ms(run, device) if timing else None
    plain_ms = timed_ms(plain, device) if timing else None
    steps = int(a_vals.shape[0])
    # the bound: 2 flops per nonzero per column, CSR A + B read once, C
    # written once; the kernel's tile-padded work beside it
    true_flops = 2 * h.nnz * n_cols
    bound_ms, bound_by = bound(
        csr_bytes(h.nrows, h.nnz) + 4 * h.ncols * n_cols
        + 4 * h.nrows * n_cols, true_flops)
    tile_flops = 2 * steps * bcc.block_r * bcc.block_k * n_cols
    tile_bytes = (a_vals.numel() * 4 + b.numel() * 4 + got.numel() * 4
                  + 8 * steps + 4 * (nblocks + 1))
    tile_bound_ms, tile_bound_by = bound(tile_bytes, tile_flops)
    hc = torch_csr(h, device)
    lib_ms = (library_ms(lambda: torch.sparse.mm(hc, b), device)
              if timing else None)
    case = {"case": name, "rows": h.nrows, "nnz": h.nnz,
            "block_k": bcc.block_k, "b_shape": [h.ncols, n_cols],
            "steps": steps, "true_flops": true_flops,
            "tile_flops": tile_flops, "max_abs_err": err,
            "tolerance": "exact (torch.equal)", "matched": ok, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR A + B + C once / 3.35 TB/s, "
                           "2*nnz*N flops / 67 TFLOP/s fp32)"),
            "tile_bound_ms": tile_bound_ms, "tile_bound_by": tile_bound_by,
            "tile_bound_rule": ("max(bytes: A stream + B + C + index arrays "
                                "once / 3.35 TB/s, tile fp32 FMAs "
                                "2*steps*8*block_k*N / 67 TFLOP/s)"),
            "library": "torch.sparse.mm(csr, dense)", "library_ms": lib_ms,
            "compare_launches": cluster_spmm_compact.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"SpMM kernel disagrees with its plain version on "
                         f"{name}: max abs err {err}")
    return case


def padded_case(name, a, b, device, *, b_dtype=None, timing=True):
    """The padded-grid kernel (K6) on the wide A·B the serving path packs:
    B too wide for the live-pair grid's C row strip."""
    import torch
    from repro_torch.core.formats import (bcc_from_host, select_block_k,
                                          tiled_csr_from_host)
    from repro_torch.core.spgemm import flops_spgemm
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spgemm import (
        cluster_spgemm_padded, cluster_spgemm_padded_plain)
    launches0 = cluster_spgemm_padded.launches
    bk = select_block_k(b)
    bcc = bcc_from_host(a, block_k=bk, device=device)
    tiled = tiled_csr_from_host(b, block_k=bk, device=device,
                                dtype=b_dtype or torch.float32)
    pack = ops.pack_spgemm(bcc, tiled)
    del bcc
    if pack.route != "padded":
        raise SystemExit(f"{name}: expected the padded route, got "
                         f"{pack.route}")
    grid, a_vals = pack.launch, pack.stream[2]
    run = lambda: cluster_spgemm_padded(grid, a_vals,  # noqa: E731
                                        tiled.tiles)
    plain = lambda: cluster_spgemm_padded_plain(  # noqa: E731
        grid, a_vals, tiled.tiles)
    got, want = run(), plain()
    ok = bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    ms = timed_ms(run, device) if timing else None
    plain_ms = timed_ms(plain, device, reps=3) if timing else None
    # the bound: A·B's true flops, both CSR operands read once, the dense
    # result (in B's dtype, as the kernel writes it) written once
    true_flops = flops_spgemm(a, b)
    out_bytes = got.numel() * got.element_size()
    bound_ms, bound_by = bound(csr_bytes(a.nrows, a.nnz)
                               + csr_bytes(b.nrows, b.nnz) + out_bytes,
                               true_flops)
    # the kernel's own work: every live (step, j) lookup is a padded tile
    # product, and every tile of C is written
    js = torch.arange(grid.nnb, device=device)
    live = int((grid.table[grid.tile_ids.long()[:, None] * grid.nnb + js]
                > 0).sum())
    tile_flops = 2 * live * grid.block_r * bk * grid.bn
    tile_bytes = (a_vals.numel() * 4
                  + tiled.tiles.numel() * tiled.tiles.element_size()
                  + out_bytes + 4 * (grid.nblocks + 1)
                  + 4 * grid.tile_ids.numel() + 4 * grid.table.numel())
    tile_bound_ms, tile_bound_by = bound(tile_bytes, tile_flops)
    ha, hb = torch_csr(a, device), torch_csr(b, device)
    lib_ms = (library_ms(lambda: torch.sparse.mm(ha, hb).to_dense(), device)
              if timing else None)
    case = {"case": name, "a_shape": list(a.shape), "a_nnz": a.nnz,
            "b_shape": list(b.shape), "b_nnz": b.nnz, "block_k": bk,
            "nnb": grid.nnb, "b_dtype": str(tiled.tiles.dtype).replace(
                "torch.", ""),
            "out_shape": list(grid.out_shape), "ctas": grid.nblocks * grid.nnb,
            "live_tile_products": live, "true_flops": true_flops,
            "tile_flops": tile_flops, "out_bytes": out_bytes,
            "max_abs_err": err, "tolerance": "exact (torch.equal)",
            "matched": ok, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR A + CSR B once + dense C once "
                           "in B's dtype / 3.35 TB/s, true flops "
                           "(flops_spgemm) / 67 TFLOP/s fp32)"),
            "tile_bound_ms": tile_bound_ms, "tile_bound_by": tile_bound_by,
            "tile_bound_rule": ("max(bytes: A stream + B tiles + C + index "
                                "arrays once / 3.35 TB/s, 2*live (step, j) "
                                "lookups*8*block_k*bn / 67 TFLOP/s)"),
            "library": "torch.sparse.mm(csr, csr).to_dense()",
            "library_ms": lib_ms,
            "compare_launches": cluster_spgemm_padded.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"padded kernel disagrees with its plain version "
                         f"on {name}: max abs err {err}")
    return case


def stream_cases(label, h, device, configs, *, timing=True):
    """The revisit (K7) and sharded (K8) kernels on ``h @ h`` at the
    serving packing, one case per ``(shards, revisit)`` config: each
    against its plain version and against the window kernel's dense
    strips (the same sums in the same order: bit-identical)."""
    import torch
    from repro_torch.core.formats import (bcc_from_host, select_block_k,
                                          tiled_csr_from_host)
    from repro_torch.core.spgemm import flops_spgemm
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spgemm import (
        Segments, cluster_spgemm_revisit, cluster_spgemm_revisit_plain,
        cluster_spgemm_sharded, cluster_spgemm_sharded_plain,
        cluster_spgemm_windows)
    bk = select_block_k(h)
    bcc = bcc_from_host(h, block_k=bk, device=device)
    tiled = tiled_csr_from_host(h, block_k=bk, device=device)
    flat = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    base = cluster_spgemm_windows(flat.launch, flat.stream[2], tiled.tiles)
    del flat
    true_flops = flops_spgemm(h, h)
    bound_ms, bound_by = bound(csr_bytes(h.nrows, h.nnz)
                               + 4 * h.nrows * h.ncols, true_flops)
    hc = torch_csr(h, device)
    lib_ms = (library_ms(lambda: torch.sparse.mm(hc, hc).to_dense(), device)
              if timing else None)
    cases = []
    for shards, revisit in configs:
        pack = ops.pack_spgemm(bcc, tiled, shards=shards, revisit=revisit)
        work, a_vals = pack.launch, pack.stream[2]
        nshards = len(pack.shard_pack[1])
        if isinstance(work, Segments) and nshards == 1:
            kernel, fn, plain_fn = ("cluster_spgemm_revisit",
                                    cluster_spgemm_revisit,
                                    cluster_spgemm_revisit_plain)
        else:
            kernel, fn, plain_fn = ("cluster_spgemm_sharded",
                                    cluster_spgemm_sharded,
                                    cluster_spgemm_sharded_plain)
        launches0 = fn.launches
        run = lambda: fn(work, a_vals, tiled.tiles)  # noqa: E731
        plain = lambda: plain_fn(work, a_vals, tiled.tiles)  # noqa: E731
        got, want = run(), plain()
        ok = bool(torch.equal(got, want)) and bool(torch.equal(got, base))
        err = max(float((got - want).abs().max()),
                  float((got - base).abs().max()))
        # few shards leave most SMs idle: fewer timed repetitions
        reps = 3 if nshards < 32 else 5
        ms = timed_ms(run, device, reps=reps) if timing else None
        plain_ms = timed_ms(plain, device, reps=3) if timing else None
        npairs = work.npairs
        tile_flops = 2 * npairs * work.block_r * bk * work.bn
        tile_bytes = (a_vals.numel() * 4 + tiled.tiles.numel() * 4
                      + got.numel() * 4 + 12 * npairs)
        tile_bound_ms, tile_bound_by = bound(tile_bytes, tile_flops)
        case = {"case": f"{kernel} ({label}, shards={shards}, "
                        f"revisit={revisit})",
                "kernel": kernel, "rows": h.nrows, "nnz": h.nnz,
                "block_k": bk, "shards": nshards,
                "window_blocks": pack.shard_pack[2],
                "ctas": (work.nseg if kernel == "cluster_spgemm_revisit"
                         else nshards),
                "pairs": npairs, "true_flops": true_flops,
                "tile_flops": tile_flops, "max_abs_err": err,
                "tolerance": ("exact (torch.equal) against the plain "
                              "version and the window kernel"),
                "matched": ok, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_rule": ("max(bytes: CSR A once + dense C once / "
                               "3.35 TB/s, true flops / 67 TFLOP/s fp32)"),
                "tile_bound_ms": tile_bound_ms,
                "tile_bound_by": tile_bound_by,
                "library": "torch.sparse.mm(csr, csr).to_dense()",
                "library_ms": lib_ms,
                "compare_launches": fn.launches - launches0}
        log("  case", json.dumps(case))
        if not ok:
            raise SystemExit(f"{kernel} disagrees with its plain version or "
                             f"the window kernel on {label}: max abs err "
                             f"{err}")
        cases.append(case)
        del got, want, pack, work
    return cases


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------


def device_time(prof) -> tuple[float, dict]:
    """Summed duration of the device-side events (kernels, copies,
    memsets) of a profiler window — one stream, so they do not overlap —
    and the five largest by name, in ms. Host-side operator events are
    left out: their device time repeats the kernels they launched."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    return sum(by_name.values()) / 1e3, {k[:60]: v for k, v in top.items()}


def scipy_result(h, b, hops):
    """The request's product by scipy: A² / A·B / A·dense B densified,
    A^(hops+1) as a sorted CSR."""
    hs = scipy_csr(h)
    if hops is not None:
        c = hs
        for _ in range(hops):
            c = c @ hs
        c.sort_indices()
        return c
    if b is None:
        return (hs @ hs).toarray()
    if isinstance(b, np.ndarray):
        return hs @ b
    return (hs @ scipy_csr(b)).toarray()


def same_result(resp, want, hops) -> bool:
    if hops is None:
        return bool(np.array_equal(resp.result, want.astype(np.float32)))
    got = resp.result
    return (tuple(got.shape) == tuple(want.shape)
            and np.array_equal(got.indptr, want.indptr)
            and np.array_equal(got.indices, want.indices)
            and np.array_equal(got.data, want.data.astype(np.float32)))


def serve_phase(mats, device, rng, spmm_cols):
    import torch
    from repro_torch.core.formats import HostCSR
    from repro_torch.kernels.cluster_spgemm import (cluster_spgemm_padded,
                                                    cluster_spgemm_windows)
    from repro_torch.kernels.cluster_spmm import cluster_spmm_compact
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import get_tracer
    from repro_torch.planner.cost_model import Candidate
    from repro_torch.planner.features import fingerprint
    from repro_torch.planner.plan_cache import Plan, PlanCache
    from repro_torch.planner.service import Planner, _materialize
    from repro_torch.resilience import ResiliencePolicy, faults
    from repro_torch.serve.engine import SpGEMMServer

    kron, cave = mats["kron"], mats["cave"]
    wide_a, wide_b = mats["wide_a"], mats["wide_b"]
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(kron), reorder="original",
                   scheme="pallas", reuse_hint=20))
    perm, bounds, mc, _ = _materialize(cave, Candidate("rcm", "pallas"))
    cache.put(Plan(fingerprint=fingerprint(cave), reorder="rcm",
                   scheme="pallas", reuse_hint=20, max_cluster=mc,
                   perm=perm, boundaries=bounds))
    cache.put(Plan(fingerprint=fingerprint(kron), reorder="original",
                   scheme="pallas", reuse_hint=20, workload="spmm"))
    cache.put(Plan(fingerprint=fingerprint(wide_a), reorder="original",
                   scheme="pallas", reuse_hint=20))
    # the chain's two hops: pallas plans for the patterns of A and A²
    # (A² by scipy), so both hops run the sparse-C route
    c1 = scipy_csr(cave) @ scipy_csr(cave)
    c1.sort_indices()
    for left in (cave, HostCSR(c1.indptr.astype(np.int32),
                               c1.indices.astype(np.int32),
                               c1.data.astype(np.float32), c1.shape)):
        cache.put(Plan(fingerprint=fingerprint(left), reorder="original",
                       scheme="pallas", reuse_hint=20, workload="chain"))
    server = SpGEMMServer(Planner(cache=cache, device=device),
                          default_reuse_hint=20)
    reg = obs_metrics.get_registry()
    variants = ("resident", "streamed", "streamed_db", "sparse_c", "padded")

    def route_counts():
        return {v: reg.counter("kernel_launches", variant=v).value
                for v in variants}

    def launch_counts():
        return (cluster_spgemm_windows.launches,
                cluster_spmm_compact.launches,
                cluster_spgemm_padded.launches)

    # two fresh-valued requests per A² matrix (plan-cache hits that pack
    # anew), then one repeat of the last values: the exec-cache hit of
    # steady serving, which goes straight to the kernel
    requests = ([("kron", "a2", "dense", False)] * 2
                + [("kron", "a2", "dense", True)]
                + [("cave", "a2", "sparse", False)] * 2
                + [("cave", "a2", "sparse", True)]
                + [("kron", "spmm", "spmm", False)]
                + [("wide", "a2", "padded", False),
                   ("wide", "a2", "padded", True)]
                + [("cave", "chain", "chain", False)])
    want_launch = {"dense": (1, 0, 0), "sparse": (1, 0, 0),
                   "spmm": (0, 1, 0), "padded": (0, 0, 1),
                   "chain": (2, 0, 0), "chaos": (0, 0, 0),
                   "replanned": (0, 0, 0)}
    want_routes = {"dense": None, "sparse": {"sparse_c": 1},
                   "spmm": {}, "padded": {"padded": 1},
                   "chain": {"sparse_c": 2}, "chaos": {},
                   "replanned": {}}
    # the chaos request: a kernel_launch fault on a kron-14 request of a
    # server with its own resilience policy, degraded to the fixed rung;
    # the next request plans around the quarantined pallas plan
    chaos_cache = PlanCache()
    chaos_cache.put(Plan(fingerprint=fingerprint(kron), reorder="original",
                         scheme="pallas", reuse_hint=20))
    chaos_policy = ResiliencePolicy()
    chaos = SpGEMMServer(Planner(cache=chaos_cache, device=device,
                                 resilience=chaos_policy),
                         default_reuse_hint=20)
    requests += [("kron", "a2", "chaos", False),
                 ("kron", "a2", "replanned", True)]
    # spans split each request's execute_s: host packing (a miss), the
    # kernel span (launch, device sync, copy to host, un-permutation) and
    # the output guard after it
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the main path's run: counters zeroed just before, read just after
    cluster_spgemm_windows.launches = 0
    cluster_spmm_compact.launches = 0
    cluster_spgemm_padded.launches = 0
    rows = []
    for i, (name, workload, route, repeat) in enumerate(requests):
        if not repeat:
            h = integer_valued(wide_a if name == "wide" else mats[name],
                               rng)
        b, hops = None, None
        if workload == "spmm":
            b = rng.integers(1, 4, (h.ncols, spmm_cols)).astype(np.float32)
        elif name == "wide":
            b = wide_b
        elif workload == "chain":
            hops = 2
        before = (launch_counts(), route_counts())
        # every request on the card is profiled for its device time
        profile = device.type == "cuda"
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
        target = chaos if route in ("chaos", "replanned") else server
        fault = (faults.injected(faults.FaultPlan(0, sites=["kernel_launch"]))
                 if route == "chaos" else contextlib.nullcontext())
        with ctx as prof, fault:
            resp = target.submit(h, b, hops=hops)
        after = (launch_counts(), route_counts())
        d_launch = tuple(x - y for x, y in zip(after[0], before[0]))
        d_route = {k: after[1][k] - before[1][k] for k in after[1]}
        exact = same_result(resp, scipy_result(h, b, hops), hops)
        if want_routes[route] is None:      # one dense-strip variant
            route_ok = (d_route["sparse_c"] == d_route["padded"] == 0
                        and sum(d_route.values()) == 1)
        else:
            route_ok = all(d_route[k] == want_routes[route].get(k, 0)
                           for k in d_route)
        counted = (d_launch == want_launch[route] or device.type == "cpu")
        busy, top = device_time(prof) if profile else (None, None)
        span_s = {}
        for sp_ in tracer.spans():
            if sp_.trace_id == resp.trace_id:
                span_s[sp_.name] = span_s.get(sp_.name, 0.0) + sp_.duration
        row = {"request": i, "matrix": name, "workload": resp.workload,
               "repeat": repeat,
               "scheme": resp.scheme, "reorder": resp.reorder,
               "plan_cache_hit": resp.plan_cache_hit, "route": route,
               "route_ok": route_ok, "window_launches": d_launch[0],
               "spmm_launches": d_launch[1], "padded_launches": d_launch[2],
               "degraded": resp.degraded,
               "fallback_scheme": resp.fallback_scheme, "exact": exact,
               "plan_s": resp.plan_s, "execute_s": resp.execute_s,
               "device_busy_s": busy, "device_top_ms": top,
               "host_share_of_execute": (None if busy is None or busy <= 0
                                         else 1.0 - busy / resp.execute_s),
               "pack_s": span_s.get("pack", 0.0),
               "kernel_span_s": span_s.get("kernel", 0.0),
               "guard_s": (resp.execute_s - span_s.get("execute", 0.0)
                           if hops is None else None)}
        log("  request", json.dumps(row))
        rows.append(row)
        if route == "chaos":
            ok = (resp.degraded and resp.fallback_scheme == "fixed"
                  and chaos_policy.stats["quarantined"] == 1)
        elif route == "replanned":
            ok = (resp.scheme != "pallas" and not resp.plan_cache_hit
                  and not resp.degraded)
        else:
            ok = (resp.scheme == "pallas" and resp.plan_cache_hit
                  and not resp.degraded)
        if not (ok and exact and route_ok and counted):
            raise SystemExit(f"serving request {i} ({name}, {route}) "
                             f"failed its checks: {row}")
    launches = {"cluster_spgemm_windows": cluster_spgemm_windows.launches,
                "cluster_spmm_compact": cluster_spmm_compact.launches,
                "cluster_spgemm_padded": cluster_spgemm_padded.launches}
    tracer.disable()
    tracer.clear()
    log("  main-path launches", json.dumps(launches))
    log("  chaos server resilience", json.dumps(chaos.stats()["resilience"]))
    # every fresh-valued request added a packed entry: the exec cache
    # holds what the launches read, within its byte cap
    planner = server.planner
    held = {"exec_entries": planner.stats["exec_entries"],
            "exec_bytes": planner.stats["exec_bytes"],
            "exec_cap_bytes": planner._exec_cache_bytes_cap,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}
    log("  exec cache", json.dumps(held))
    if held["exec_bytes"] > held["exec_cap_bytes"]:
        raise SystemExit(f"exec cache over its byte cap: {held}")
    if device.type == "cuda" and launches != {"cluster_spgemm_windows": 8,
                                              "cluster_spmm_compact": 1,
                                              "cluster_spgemm_padded": 2}:
        raise SystemExit(f"launch counts off the main path: {launches}")
    del chaos, server

    # one unseeded request in measured mode: the choice is printed only
    measured = SpGEMMServer(device=device, measure=True)
    t0 = time.perf_counter()
    resp = measured.submit(integer_valued(cave, rng))
    log("  measured-mode request", json.dumps({
        "matrix": "cave", "scheme": resp.scheme, "reorder": resp.reorder,
        "plan_s": resp.plan_s, "execute_s": resp.execute_s,
        "wall_s": time.perf_counter() - t0}))
    return launches, rows


def sharded_phase(h, device, sm_count):
    """The entry point of the sharded and revisit routes:
    ``bcc_spgemm_tiled(shards=…, revisit=…)`` on kron-14, counters zeroed
    just before and read just after; every result must equal scipy's."""
    import torch
    from repro_torch.core.formats import (bcc_from_host, select_block_k,
                                          tiled_csr_from_host)
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spgemm import (cluster_spgemm_revisit,
                                                    cluster_spgemm_sharded)
    bk = select_block_k(h)
    bcc = bcc_from_host(h, block_k=bk, device=device)
    tiled = tiled_csr_from_host(h, block_k=bk, device=device)
    want = scipy_result(h, None, None)
    calls = [dict(revisit=True), dict(shards=sm_count),
             dict(shards=sm_count, revisit=True)]
    cluster_spgemm_revisit.launches = 0
    cluster_spgemm_sharded.launches = 0
    for kw in calls:
        t0 = time.perf_counter()
        out = ops.bcc_spgemm_tiled(bcc, tiled, **kw)
        synchronize(device)
        wall = time.perf_counter() - t0
        exact = bool(np.array_equal(out.cpu().numpy(), want))
        log("  call", json.dumps({"bcc_spgemm_tiled": kw,
                                  "wall_s_with_packing": wall,
                                  "exact": exact}))
        if not exact:
            raise SystemExit(f"bcc_spgemm_tiled({kw}) differs from scipy")
        del out
    launches = {"cluster_spgemm_revisit": cluster_spgemm_revisit.launches,
                "cluster_spgemm_sharded": cluster_spgemm_sharded.launches}
    log("  sharded-path launches", json.dumps(launches))
    if device.type == "cuda" and launches != {"cluster_spgemm_revisit": 1,
                                              "cluster_spgemm_sharded": 2}:
        raise SystemExit(f"launch counts off the sharded path: {launches}")
    return launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rehearse", action="store_true",
                        help="run the phases on the CPU at small sizes "
                             "(plain versions) and exit 2")
    args = parser.parse_args(argv)

    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from repro_torch.core import suite
        from repro_torch.core.formats import HostCSR
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- phase 1: environment ------------------------------------------------
    if args.rehearse:
        device = torch.device("cpu")
        smi = "rehearsal on the CPU"
        log("phase 1: rehearsal on the CPU (no card, no kernel build)")
    else:
        device = torch.device("cuda")
        smi = nvidia_smi_line()
        log("phase 1: environment")
        log(f"  gpu: {smi}")
        log(f"  torch {torch.__version__}, cuda {torch.version.cuda}, "
            f"python {sys.version.split()[0]}")
        build_s, build_logs = _build.build_all()
        log(f"  kernel build: {build_s:.2f} s ({len(build_logs)} sources, "
            "one nvcc each, in parallel)")
        for name, text in build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {name}: {line.strip()}")
    sm_count = (torch.cuda.get_device_properties(0).multi_processor_count
                if device.type == "cuda" else 132)
    log(f"  streaming multiprocessors: {sm_count}"
        + (" (the H100 SXM's count, for the rehearsal)"
           if device.type == "cpu" else ""))

    # -- matrices (suite generators, seeded) -----------------------------------
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if args.rehearse:
        kron = suite.gen_kron(10, 16, seed=0)
        cave = suite.gen_caveman(4096, 24, seed=0)
        plaw = suite.gen_powerlaw(512, 12, seed=3)
        # still wider than the live-pair grid's strip budget (65,536)
        mesh, wide_rows = suite.gen_mesh2d(258, seed=0, stencil=5), 256
        spmm_cols, ragged_cols = 16, 10
    else:
        kron = suite.gen_kron(14, 16, seed=0)
        cave = suite.gen_caveman(16384, 24, seed=0)
        plaw = suite.generate(next(s for s in suite.SUITE
                                   if s.name == "plaw_4096_12"))
        mesh, wide_rows = suite.gen_mesh2d(288, seed=0, stencil=5), 8192
        spmm_cols, ragged_cols = 64, 40
    # the wide A·B: a 2-hop frontier expansion of a batch of source
    # vertices (A = the first rows of the mesh, all its columns)
    wide_b = integer_valued(mesh, rng)
    wide_a = HostCSR(mesh.indptr[: wide_rows + 1],
                     mesh.indices[: mesh.indptr[wide_rows]],
                     mesh.data[: mesh.indptr[wide_rows]],
                     (wide_rows, mesh.ncols))
    mats = {"kron": kron, "cave": cave, "wide_a": wide_a, "wide_b": wide_b}
    log(f"  matrices: kron {kron.shape} nnz {kron.nnz}, caveman "
        f"{cave.shape} nnz {cave.nnz}, powerlaw {plaw.shape} nnz "
        f"{plaw.nnz}, wide A {wide_a.shape} nnz {wide_a.nnz} x mesh "
        f"{wide_b.shape} nnz {wide_b.nnz} "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- phase 2: kernels vs plain versions ------------------------------------
    log("phase 2: kernels against their plain versions")
    kron_i = integer_valued(kron, rng)
    cave_i = integer_valued(cave, rng)
    timing = not args.rehearse          # CPU times say nothing of a card
    dense, kron_windows, _ = window_case("dense-output window (kron)",
                                         kron_i, device, sparse_c=False,
                                         timing=timing)
    slab, _, _ = window_case("slab-output window (caveman)", cave_i,
                             device, sparse_c=True, timing=timing)
    tall, _, _ = window_case("block_k=512 window (powerlaw)",
                             integer_valued(plaw, rng), device,
                             sparse_c=False, timing=timing)
    kron_u = HostCSR(kron.indptr, kron.indices, rng.uniform(
        0.5, 2.0, kron.nnz).astype(np.float32), kron.shape)
    # bf16 tiles: kernel vs plain on the same bf16 inputs differ only by
    # fp32 summation order (bound 1e-5 of the largest value); vs the fp32
    # tiles the documented bf16 bound is 2e-2 relative
    bf16, _, got_bf16 = window_case(
        "bf16 B tiles window (kron)", kron_u, device, sparse_c=False,
        b_dtype=torch.bfloat16, windows=kron_windows, tol=1e-5,
        timing=timing)
    _, _, got_f32 = window_case(
        "fp32 B tiles window (kron, bf16 reference)", kron_u, device,
        sparse_c=False, windows=kron_windows, tol=1e-5, timing=False)
    rel = float((got_bf16 - got_f32).abs().max()
                / got_f32.abs().max().clamp_min(1e-30))
    log(f"  bf16 vs fp32 tiles: max relative error {rel:.3e} (bound 2e-2)")
    if not rel < 2e-2:
        raise SystemExit(f"bf16 tiles exceed the 2e-2 bound: {rel}")
    del got_bf16, got_f32
    spmm = spmm_case("compact SpMM, dense B (kron)", kron_i, spmm_cols,
                     device, rng, timing=timing)
    ragged = spmm_case("compact SpMM, ragged N (kron)", kron_i, ragged_cols,
                       device, rng, timing=timing)
    wide_i = integer_valued(wide_a, rng)
    padded = padded_case("padded grid, wide A·B (mesh)", wide_i, wide_b,
                         device, timing=timing)
    # integer sums up to 45 round to bf16 exactly: the bf16 output too
    # must equal its plain version bit for bit
    padded_bf16 = padded_case("padded grid, bf16 B tiles (mesh)", wide_i,
                              wide_b, device, b_dtype=torch.bfloat16,
                              timing=timing)
    # 8 shards of kron-14 would leave a million pairs to each of 8 CTAs:
    # the 8-shard cases run on caveman-16384 only
    kron_streams = stream_cases(
        "kron", kron_i, device,
        [(1, True), (sm_count, False), (sm_count, True)], timing=timing)
    cave_streams = stream_cases(
        "caveman", cave_i, device,
        [(1, True), (8, False), (8, True), (sm_count, False),
         (sm_count, True)], timing=timing)
    stream_all = kron_streams + cave_streams

    # -- phase 3: the serving path ---------------------------------------------
    log("phase 3: SpGEMMServer.submit with seeded pallas plans")
    launches, _ = serve_phase(mats, device, rng, spmm_cols)
    log("phase 3b: bcc_spgemm_tiled(shards=..., revisit=...) on kron")
    launches.update(sharded_phase(kron_i, device, sm_count))

    # -- phase 4: summary ------------------------------------------------------
    win_cases = [dense, slab, tall, bf16]
    spmm_cases = [spmm, ragged]
    revisit_cases = [c for c in stream_all
                     if c["kernel"] == "cluster_spgemm_revisit"]
    sharded_cases = [c for c in stream_all
                     if c["kernel"] == "cluster_spgemm_sharded"]
    sharded_main = next(c for c in sharded_cases
                        if c["shards"] == sm_count
                        and c["window_blocks"] is None)

    def entry(name, source, replaces, cases, main):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "tile_bound_ms": main["tile_bound_ms"],
                "library_ms": main["library_ms"],
                "matched": all(c["matched"] for c in cases),
                "cases": cases}

    kernels = {"kernels": [
        entry("cluster_spgemm_windows",
              "src/repro_torch/kernels/csrc/cluster_spgemm.cu",
              "src/repro/kernels/cluster_spgemm.py:336 (K1 "
              "cluster_spgemm_pairs; also :389 K2, :462 K3, :746 K5a, "
              ":816 K5b)", win_cases, dense),
        entry("cluster_spmm_compact",
              "src/repro_torch/kernels/csrc/cluster_spmm.cu",
              "src/repro/kernels/cluster_spmm.py:168 (K4 "
              "cluster_spmm_compact)", spmm_cases, spmm),
        entry("cluster_spgemm_padded",
              "src/repro_torch/kernels/csrc/cluster_spgemm_padded.cu",
              "src/repro/kernels/cluster_spgemm.py:199 (K6a "
              "cluster_spgemm_tiled; also :261 K6b cluster_spgemm_resident)",
              [padded, padded_bf16], padded),
        entry("cluster_spgemm_revisit",
              "src/repro_torch/kernels/csrc/cluster_spgemm_revisit.cu",
              "src/repro/kernels/cluster_spgemm.py:537 (K7 "
              "cluster_spgemm_pairs_window)", revisit_cases,
              revisit_cases[0]),
        entry("cluster_spgemm_sharded",
              "src/repro_torch/kernels/csrc/cluster_spgemm.cu",
              "src/repro/kernels/cluster_spgemm.py:594 (K8 "
              "cluster_spgemm_pairs_sharded, the shard_map dispatch; "
              "window_sharded_kernel here, segment_sharded_kernel in "
              "csrc/cluster_spgemm_revisit.cu)", sharded_cases,
              sharded_main),
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    if args.rehearse:
        print("rehearsal finished: no card was used", flush=True)
        return 2
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
