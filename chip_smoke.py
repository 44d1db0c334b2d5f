#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root with one CUDA card visible::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed,
after one stdout line ``chip_smoke: failed in <phase>: <error>``; so does
a run without a card, or from a directory that does not hold the port):

1. environment — the card's name and power limit, the CUDA version, the
   SM count, and the build of every kernel source with nvcc (one process
   per source, all started together, into ``build/repro_torch/``), with
   each kernel's registers and spills from ``ptxas -v``;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it: integer-valued operands compare
   exactly (``torch.equal``); each case prints its time (CUDA events,
   median of 5 — 3 for slow cases — after a warm-up), the plain
   version's, the bound (from the work the product needs: true flops, CSR
   operands read once, the result written once), the bound of the
   kernel's tile-padded work beside it, and one PyTorch library call
   timed as a yardstick the port never calls; the kernels that walk A's
   live slab columns also print their own device time (profiler) and
   the work bound of that walk (the window and compact SpMM kernels also
   the time to build the live-column form, the revisit and sharded
   kernels the window kernel's time on the same product and the CTAs
   launched); the padded-grid and flash-attention kernels print their
   device time too, the padded grid its live tiles and its zero-fill's
   rate. The kernels: the window
   kernel (kron-14 dense strips, caveman-16384 slabs, a block_k = 512
   case, bf16 tiles), the compact SpMM kernel (kron-14 with N = 64 and a
   ragged 40, caveman-16384, the block_k = 512 powerlaw, and
   SparseLinear's dense-slab layer), the padded-grid kernel on
   a wide A·B (the first 8,192 rows of a 288 × 288 mesh times the mesh:
   82,944 columns, past the live-pair grid's strip budget; fp32 and bf16
   tiles), the revisit kernel and the sharded kernel (kron-14 with 1 and
   SM-count shards, caveman-16384 with 1, 8 and SM-count shards, with and
   without the revisit order, and the revisit kernel on kron-14 times its
   first 256 columns, whose 256-block windows run as 4-block segments —
   each also equal to the window kernel's strips), the Sp×Sp kernels on
   a B holding inf, -inf and NaN (kron-12 squared: the dense strips, the
   CompactedC slabs, the padded grid, the revisit order and 8 shards in
   both orders, each position for position equal to its plain version and
   to the dense strips; the window, padded-grid and revisit cases print
   the non-finite census's tiles, bytes and device time on finite B), the
   padded-lattice SpMM kernel on SparseLinear's weight (a
   2,560 × 10,240 weight at density 0.1 with seeded tile sets and
   shuffled rows, 4,096 tokens; exact on integer values; its panels, the
   distinct B tiles per panel slot and the modelled B bytes printed; the
   same weight packed without the clustering reorder beside it), the
   flash-attention kernel (zamba2-2.7b's prefill shape (128, 1024, 80)
   causal, a ragged S = 1000 and a D = 128 case) and the SSD chunk-scan
   kernel (zamba2-2.7b's (320, 4, 256, 64/64) and the single-chunk
   fallback Q = 300); the last two within the tolerances they print;
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
3c. SparseLinear — ``SparseLinear.apply(x, compact=False)`` (the padded
   lattice) and ``apply(x)`` (the compact stream's live columns, kept
   with the layer) on the phase-2 layer, once each, equal to the dense
   pruned product; then ``apply`` on the activations with an inf at a
   dead slab column's feature, a -inf and a NaN, equal to the plain
   version position for position, the dead column's block NaN;
3d. LM serving, after the SpGEMM phases' memory is released —
   ``run_serving("zamba2-2.7b", smoke=False, batch=4, prompt_len=1024,
   gen=32)``: 54 Mamba2 layers, d_model 2560, 2.42 B random fp32
   parameters; its prefill must launch the flash-attention kernel 9 times
   and the SSD kernel 54 times, every greedy token must lie in the
   vocabulary; then the same weights and prompts are prefilled again
   through the kernels (profiled: device time per kernel) and through
   the model's own chunked path, whose logits must agree within the
   printed tolerance, all finite; prints prefill and decode times, tok/s
   and the peak device memory;
4. summary — one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line,
   and last ``{"ok": true, "device": {...}}``.

``--rehearse`` runs the same phases on the CPU at small sizes through the
plain versions (no launch counts, no timings; the LM phase on
``smoke_config("zamba2-2.7b")``) and exits 2 without the final line: a dry run of the control flow before a card is used
(``tests/test_torch_smoke.py`` runs it).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
PEAK_16_FLOPS = 989e12     # bf16 and fp16 on the tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12


def log(*parts) -> None:
    print(*parts, flush=True)


# the phase running now, named in the line a failed run prints last
PHASE = "start"


def phase(title: str) -> None:
    """Log a phase's header and remember it for a failure's last line."""
    global PHASE
    PHASE = title.split(":")[0]
    log(title)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` output: the entry
    function (demangled where ``c++filt`` is on the path), its registers
    and its spill stores and loads."""
    import re
    import shutil
    entries, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split("info", 1)[-1].lstrip(" :")
            entries.append((name, f"{used.strip()}; {spill}"))
            name, spill = None, ""
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(
            n for n, _ in entries), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(out) == len(entries):
            entries = [(d, r) for d, (_, r) in zip(out, entries)]
    return [f"{n}: {r}" for n, r in entries]


def integer_valued(h, rng):
    """Same pattern, fresh values in {1, 2, 3}: fp32 sums stay exact."""
    from repro_torch.core.formats import HostCSR
    return HostCSR(h.indptr, h.indices,
                   rng.integers(1, 4, h.nnz).astype(np.float32), h.shape)


def first_columns(h, n: int):
    """``h``'s first ``n`` columns, as a HostCSR."""
    from repro_torch.core.formats import HostCSR
    c = scipy_csr(h)[:, :n].tocsr()
    c.sort_indices()
    return HostCSR(c.indptr.astype(np.int64), c.indices.astype(np.int32),
                   c.data.astype(np.float32), c.shape)


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


def kernel_device_ms(fn, device, kernel, reps: int = 5, *,
                     split: bool = False):
    """Median device time of the kernels whose names contain ``kernel`` (a
    name, or a tuple of names summed) in one call of ``fn``, from the
    profiler's device events: the kernels alone, without the wrapper's
    host work and its other launches (zero-fill, stream offsets), which
    the CUDA-event time of a call includes. A profiling session that
    misses one of the kernels is not counted (on the card, sessions late in
    this script have lost K10's events); after ``3 * reps`` sessions
    without ``reps`` counted, the median of those counted, None if there
    are none. ``split``: a dict of each name's median instead, the total
    under "total" (the median of the sessions' sums). None on the CPU."""
    import torch
    from torch.autograd import DeviceType
    if device.type != "cuda":
        return None
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    times = []
    for _ in range(3 * reps):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        found = [(ev.name, ev.time_range.elapsed_us())
                 for ev in prof.events() if ev.device_type == DeviceType.CUDA
                 and any(k in ev.name for k in names)]
        if all(any(k in n for n, _ in found) for k in names):
            times.append({k: sum(us for n, us in found if k in n) / 1e3
                          for k in names})
            times[-1]["total"] = sum(us for _, us in found) / 1e3
        if len(times) == reps:
            break
    if not times:
        return None
    med = {k: statistics.median(t[k] for t in times) for k in times[0]}
    return med if split else med["total"]


# the non-finite census's launches (csrc/nonfinite.cuh): the compact SpMM
# marks its tiles per launch; the Sp x Sp packs list theirs
SPMM_CENSUS_KERNELS = ("mark_tiles_kernel", "count_kernel")
SPGEMM_CENSUS_KERNEL = "count_kernel"


def census_work(census, b_tiles) -> dict:
    """What the census of a Sp x Sp launch reads on finite B: the listed
    tile slots (those some pair meets through a slab with a dead column),
    each read once (``block_k * bn`` values)."""
    tile_bytes = b_tiles[0].numel() * b_tiles.element_size()
    return {"census_tiles": int(census.numel()),
            "tile_store_tiles": int(b_tiles.shape[0]),
            "census_bytes": int(census.numel()) * tile_bytes,
            "tile_store_bytes": b_tiles.numel() * b_tiles.element_size()}


def bound(nbytes: int, flops: int,
          peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    """The least time for the work, in ms, and what sets it: ``peak`` is
    the card's rate for the type the products are formed in."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def column_work(cols, unit_slabs, row_keys, row_bytes: int, out_bytes: int,
                width: int) -> dict:
    """The live-column walk's own work, for its bound: every visit of a
    unit (a stream step, or a live pair) to a live column of its slab is
    8 FMAs per output column (``2 * 8 * width`` flops); its bytes are the
    column lists once, each distinct B row the visits select once
    (``row_bytes`` each) and the output once. ``row_keys(visit_slab,
    visit_col, visit_unit)`` names the B row of each visit."""
    import torch
    dev = cols.col_ptr.device
    slab = unit_slabs.long()
    c0 = cols.col_ptr[:-1].long()[slab]
    ncol = cols.col_ptr[1:].long()[slab] - c0
    visits = int(ncol.sum())
    unit = torch.repeat_interleave(torch.arange(slab.shape[0], device=dev),
                                   ncol)
    first = torch.cumsum(ncol, 0) - ncol
    col = c0[unit] + torch.arange(visits, device=dev) - first[unit]
    rows = int(torch.unique(row_keys(slab[unit], col, unit)).numel())
    del unit, col
    col_bytes = 4 * (cols.nslabs + 1) + 36 * cols.ncols
    flops = 2 * 8 * width * visits
    nbytes = col_bytes + rows * row_bytes + out_bytes
    ms, by = bound(nbytes, flops)
    return {"live_columns": cols.ncols, "live_column_visits": visits,
            "distinct_b_rows": rows, "work_flops": flops,
            "work_bytes": nbytes, "work_bound_ms": ms, "work_bound_by": by,
            "work_bound_rule": ("max(bytes: column lists + distinct B rows "
                                "selected + output once / 3.35 TB/s, "
                                "2*8*width flops per live-column visit / "
                                "67 TFLOP/s fp32)")}


def spmm_work(cols, tile_ids, block_k: int, n_cols: int,
              out_bytes: int, *, row_bytes: int | None = None) -> dict:
    """:func:`column_work` of the compact SpMM: each step visits its own
    slab's live columns once, and a visit selects B's row
    ``tile_ids[step] * block_k + k`` (``n_cols`` values, fp32 unless
    ``row_bytes`` says otherwise)."""
    import torch
    steps = torch.arange(cols.nslabs, device=cols.col_ptr.device)
    return column_work(
        cols, steps,
        lambda slab, col, unit: (tile_ids.long()[slab] * block_k
                                 + cols.col_k.long()[col]),
        row_bytes or 4 * n_cols, out_bytes, n_cols)


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
        census_tiles, cluster_spgemm_windows, cluster_spgemm_windows_plain)
    launches0 = cluster_spgemm_windows.launches
    bk = select_block_k(h)
    bcc = bcc_from_host(h, block_k=bk, device=device)
    tiled = tiled_csr_from_host(h, block_k=bk, device=device,
                                dtype=b_dtype or torch.float32)
    if windows is None:
        pack = ops.pack_spgemm(bcc, tiled, sparse_c=sparse_c)
        windows, a_vals, cols = pack.launch, pack.stream[2], pack.cols
        census = pack.census
    else:
        a_vals = ops.bcc_compact_stream(bcc, cover_all_blocks=True)[2]
        cols = ops.slab_columns(a_vals)
        census = census_tiles(windows, cols)
    del bcc
    # the live-column form is built once per packed operand: timed alone
    cols_ms = (timed_ms(lambda: ops.slab_columns(a_vals), device)
               if timing else None)
    run = lambda: cluster_spgemm_windows(windows, a_vals,  # noqa: E731
                                         tiled.tiles, cols, census)
    plain = lambda: cluster_spgemm_windows_plain(  # noqa: E731
        windows, a_vals, tiled.tiles, cols)
    got, want = run(), plain()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if tol is None:
        ok = bool(torch.equal(got, want))
        tol_txt = "exact (torch.equal)"
    else:
        ok = err <= tol * max(float(want.abs().max()), 1e-30)
        tol_txt = f"max|kernel-plain| <= {tol:g} x max|plain|"
    ms = timed_ms(run, device) if timing else None
    device_ms = (kernel_device_ms(run, device, "window_kernel")
                 if timing else None)
    # what the non-finite census costs on this finite B: its launch's
    # device time, and the listed tiles it reads
    census_ms = (kernel_device_ms(run, device, SPGEMM_CENSUS_KERNEL)
                 if timing else None)
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
    # the live-column walk's own work: each pair's visits to its slab's
    # live columns, the B tile rows (slot, k) they select
    work = column_work(
        cols, windows.a_idx,
        lambda slab, col, unit: (windows.slots.long()[unit] * bk
                                 + cols.col_k.long()[col]),
        windows.bn * tiled.tiles.element_size(), got.numel() * 4,
        windows.bn)
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
            "ms": ms, "kernel_device_ms": device_ms, "plain_ms": plain_ms,
            "census_device_ms": census_ms,
            **census_work(census, tiled.tiles),
            "census_share_of_ms": (census_ms / ms if census_ms else None),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR A once + result once (dense C, "
                           "or C's nonzeros as CSR on the slab route) / "
                           "3.35 TB/s, true flops (flops_spgemm) / "
                           "67 TFLOP/s fp32)"),
            "tile_bound_ms": tile_bound_ms, "tile_bound_by": tile_bound_by,
            "tile_bound_rule": ("max(bytes: A stream + B tiles + output + "
                                "index arrays once / 3.35 TB/s, tile fp32 "
                                "FMAs 2*pairs*8*block_k*bn / 67 TFLOP/s)"),
            **work, "slab_columns_ms": cols_ms,
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
    """The compact SpMM kernel (K4) on ``h`` times a dense integer B of
    ``n_cols`` columns, at the serving path's adaptive ``block_k``."""
    import torch
    from repro_torch.core.formats import bcc_from_host, select_block_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spmm import (
        KERNEL_MAX_BN, cluster_spmm_compact, cluster_spmm_compact_plain)
    launches0 = cluster_spmm_compact.launches
    bcc = bcc_from_host(h, block_k=select_block_k(h), device=device)
    block_ids, tile_ids, a_vals = ops.bcc_compact_stream(
        bcc, cover_all_blocks=True)
    cols = ops.slab_columns(a_vals)
    cols_ms = (timed_ms(lambda: ops.slab_columns(a_vals), device)
               if timing else None)
    nblocks = bcc.nblocks
    b = torch.from_numpy(rng.integers(1, 4, (h.ncols, n_cols)).astype(
        np.float32)).to(device)
    bids = torch.from_numpy(block_ids).to(device)
    tids = torch.from_numpy(tile_ids).to(device)
    kw = dict(block_r=bcc.block_r, block_k=bcc.block_k, nblocks=nblocks)
    bn = min(KERNEL_MAX_BN, n_cols)
    run = lambda: cluster_spmm_compact(bids, tids, a_vals, b,  # noqa: E731
                                       bn=bn, cols=cols, **kw)
    plain = lambda: cluster_spmm_compact_plain(  # noqa: E731
        bids, tids, a_vals, b, cols=cols, **kw)
    got, want = run(), plain()
    err = float((got - want).abs().max())
    ok = bool(torch.equal(got, want))
    ms = timed_ms(run, device) if timing else None
    device_ms = (kernel_device_ms(run, device, "spmm_columns_kernel")
                 if timing else None)
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
    work = spmm_work(cols, tids, bcc.block_k, n_cols, got.numel() * 4)
    hc = torch_csr(h, device)
    lib_ms = (library_ms(lambda: torch.sparse.mm(hc, b), device)
              if timing else None)
    case = {"case": name, "rows": h.nrows, "nnz": h.nnz,
            "block_k": bcc.block_k, "b_shape": [h.ncols, n_cols],
            "steps": steps, "true_flops": true_flops,
            "tile_flops": tile_flops, "max_abs_err": err,
            "tolerance": "exact (torch.equal)", "matched": ok, "ms": ms,
            "kernel_device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR A + B + C once / 3.35 TB/s, "
                           "2*nnz*N flops / 67 TFLOP/s fp32)"),
            "tile_bound_ms": tile_bound_ms, "tile_bound_by": tile_bound_by,
            "tile_bound_rule": ("max(bytes: A stream + B + C + index arrays "
                                "once / 3.35 TB/s, tile fp32 FMAs "
                                "2*steps*8*block_k*N / 67 TFLOP/s)"),
            **work, "slab_columns_ms": cols_ms,
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
    grid, a_vals, cols = pack.launch, pack.stream[2], pack.cols
    run = lambda: cluster_spgemm_padded(grid, a_vals,  # noqa: E731
                                        tiled.tiles, cols, pack.census)
    plain = lambda: cluster_spgemm_padded_plain(  # noqa: E731
        grid, a_vals, tiled.tiles)
    got, want = run(), plain()
    ok = bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    ms = timed_ms(run, device) if timing else None
    # the wrapper's two launches together, and the zero-fill alone
    device_ms = (kernel_device_ms(run, device, ("zero_fill_kernel",
                                                "padded_kernel"))
                 if timing else None)
    fill_ms = (kernel_device_ms(run, device, "zero_fill_kernel")
               if timing else None)
    census_ms = (kernel_device_ms(run, device, SPGEMM_CENSUS_KERNEL)
                 if timing else None)
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
    live_js = (grid.table[grid.tile_ids.long()[:, None] * grid.nnb + js]
               > 0).sum(dim=1)
    live = int(live_js.sum())
    # the tile launch multiplies each live (step, j)'s live slab columns
    visits = int((live_js * (cols.col_ptr[1:] - cols.col_ptr[:-1])).sum())
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
            "out_shape": list(grid.out_shape),
            "out_tiles": grid.nblocks * grid.nnb,
            "live_tiles": int(grid.live_tiles.numel()),
            "live_tile_share": int(grid.live_tiles.numel())
            / (grid.nblocks * grid.nnb),
            "live_tile_products": live, "live_column_visits": visits,
            "true_flops": true_flops,
            "tile_flops": tile_flops, "out_bytes": out_bytes,
            "max_abs_err": err, "tolerance": "exact (torch.equal)",
            "matched": ok, "ms": ms, "kernel_device_ms": device_ms,
            "fill_device_ms": fill_ms, "census_device_ms": census_ms,
            **census_work(pack.census, tiled.tiles),
            "fill_rate_tb_s": (out_bytes / fill_ms / 1e9
                               if fill_ms else None),
            "plain_ms": plain_ms,
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


def stream_cases(label, h, device, configs, *, b=None, timing=True):
    """The revisit (K7) and sharded (K8) kernels on ``h @ b`` (``b``
    defaults to ``h``) at the serving packing, one case per ``(shards,
    revisit)`` config: each against its plain version and against the
    window kernel's dense strips (the same sums in the same order:
    bit-identical), the window kernel timed in the same call."""
    import torch
    from repro_torch.core.formats import (bcc_from_host, select_block_k,
                                          tiled_csr_from_host)
    from repro_torch.core.spgemm import flops_spgemm
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spgemm import (
        Segments, cluster_spgemm_revisit, cluster_spgemm_revisit_plain,
        cluster_spgemm_sharded, cluster_spgemm_sharded_plain,
        cluster_spgemm_windows)
    b = h if b is None else b
    bk = select_block_k(h)
    bcc = bcc_from_host(h, block_k=bk, device=device)
    tiled = tiled_csr_from_host(b, block_k=bk, device=device)
    flat = ops.pack_spgemm(bcc, tiled, sparse_c=False)
    base_run = lambda: cluster_spgemm_windows(  # noqa: E731
        flat.launch, flat.stream[2], tiled.tiles, flat.cols, flat.census)
    base = base_run()
    base_ms = timed_ms(base_run, device) if timing else None
    del flat, base_run
    true_flops = flops_spgemm(h, b)
    csr_in = csr_bytes(h.nrows, h.nnz) + (
        0 if b is h else csr_bytes(b.nrows, b.nnz))
    bound_ms, bound_by = bound(csr_in + 4 * h.nrows * b.ncols, true_flops)
    hc = torch_csr(h, device)
    bc = hc if b is h else torch_csr(b, device)
    lib_ms = (library_ms(lambda: torch.sparse.mm(hc, bc).to_dense(), device)
              if timing else None)
    cases = []
    for shards, revisit in configs:
        pack = ops.pack_spgemm(bcc, tiled, shards=shards, revisit=revisit)
        work, a_vals, cols = pack.launch, pack.stream[2], pack.cols
        nshards = len(pack.shard_pack[1])
        segments = isinstance(work, Segments)
        # the revisit route's plain version reads the padded slabs, so it
        # holds the live-column walk to the padded sum
        if segments and nshards == 1:
            kernel, fn = "cluster_spgemm_revisit", cluster_spgemm_revisit
            plain = lambda: cluster_spgemm_revisit_plain(  # noqa: E731
                work, a_vals, tiled.tiles)
        else:
            kernel, fn = "cluster_spgemm_sharded", cluster_spgemm_sharded
            plain = lambda: cluster_spgemm_sharded_plain(  # noqa: E731
                work, a_vals, tiled.tiles, cols)
        launches0 = fn.launches
        run = lambda: fn(work, a_vals, tiled.tiles, cols,  # noqa: E731
                         pack.census)
        got, want = run(), plain()
        ok = bool(torch.equal(got, want)) and bool(torch.equal(got, base))
        err = max(float((got - want).abs().max()),
                  float((got - base).abs().max()))
        ms = timed_ms(run, device) if timing else None
        device_ms = (kernel_device_ms(
            run, device, "segment_kernel" if segments
            else "window_kernel") if timing else None)
        census_ms = (kernel_device_ms(run, device, SPGEMM_CENSUS_KERNEL)
                     if timing else None)
        plain_ms = timed_ms(plain, device, reps=3) if timing else None
        npairs = work.npairs
        tile_flops = 2 * npairs * work.block_r * bk * work.bn
        tile_bytes = (a_vals.numel() * 4 + tiled.tiles.numel() * 4
                      + got.numel() * 4 + 12 * npairs)
        tile_bound_ms, tile_bound_by = bound(tile_bytes, tile_flops)
        # the live-column walk's own work: each pair's visits to its
        # slab's live columns, the B tile rows (slot, k) they select
        walk = column_work(
            cols, work.a_idx,
            lambda slab, col, unit: (work.slots.long()[unit] * bk
                                     + cols.col_k.long()[col]),
            work.bn * 4, got.numel() * 4, work.bn)
        case = {"case": f"{kernel} ({label}, shards={shards}, "
                        f"revisit={revisit})",
                "kernel": kernel, "rows": h.nrows, "nnz": h.nnz,
                "b_cols": b.ncols, "block_k": bk, "shards": nshards,
                "window_blocks": pack.shard_pack[2],
                "segment_blocks": work.max_nblk if segments else None,
                "ctas": work.nseg if segments else work.nwin,
                "pairs": npairs, "true_flops": true_flops,
                "tile_flops": tile_flops, "max_abs_err": err,
                "tolerance": ("exact (torch.equal) against the plain "
                              "version and the window kernel"),
                "matched": ok, "ms": ms, "kernel_device_ms": device_ms,
                "census_device_ms": census_ms,
                "window_kernel_ms": base_ms,
                "vs_window_kernel": (ms / base_ms if timing else None),
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_rule": ("max(bytes: CSR A (and B) once + dense C "
                               "once / 3.35 TB/s, true flops / 67 TFLOP/s "
                               "fp32)"),
                "tile_bound_ms": tile_bound_ms,
                "tile_bound_by": tile_bound_by, **walk,
                "library": "torch.sparse.mm(csr, csr).to_dense()",
                "library_ms": lib_ms,
                "compare_launches": fn.launches - launches0}
        log("  case", json.dumps(case))
        if not ok:
            raise SystemExit(f"{kernel} disagrees with its plain version or "
                             f"the window kernel on {label}: max abs err "
                             f"{err}")
        cases.append(case)
        del got, want, pack, work, cols
    return cases


def nan_equal(got, want) -> bool:
    """Equal position for position: NaN where the other is NaN, infs of
    the same sign, equal finite values."""
    import torch
    return got.shape == want.shape and bool(torch.equal(
        got.isnan(), want.isnan())) and bool(
        ((got == want) | got.isnan()).all())


def finite_err(got, want) -> float:
    """max |got - want| over the positions where both are finite."""
    import torch
    both = got.isfinite() & want.isfinite()
    if not bool(both.any()):
        return 0.0
    return float((got.float() - want.float())[both].abs().max())


def nonfinite_spgemm_case(h, device, rng, *, shards: int = 8):
    """The Sp x Sp kernels on a B holding inf, -inf and NaN: ``h`` squared
    with 6 of B's values (seeded positions) made non-finite. Each route's
    kernel -- dense strips (K1), CompactedC slabs (K5), the padded grid
    (K6), the revisit order (K7), ``shards`` shards in both orders (K8) --
    against its plain version, position for position (the dead slab
    columns that meet a non-finite value make their blocks NaN, as the
    whole-slab product does), and every route's dense result against the
    dense strips'."""
    import torch
    from repro_torch.core.formats import (CompactedC, HostCSR, bcc_from_host,
                                          select_block_k, tiled_csr_from_host)
    from repro_torch.kernels import ops
    from repro_torch.kernels.cluster_spgemm import (
        cluster_spgemm_padded, cluster_spgemm_padded_plain,
        cluster_spgemm_revisit, cluster_spgemm_revisit_plain,
        cluster_spgemm_sharded, cluster_spgemm_sharded_plain,
        cluster_spgemm_windows, cluster_spgemm_windows_plain)
    data = h.data.copy()
    pos = rng.choice(h.nnz, 6, replace=False)
    data[pos] = [np.inf, -np.inf, np.nan, np.inf, -np.inf, np.nan]
    b = HostCSR(h.indptr, h.indices, data, h.shape)
    bk = select_block_k(h)
    bcc = bcc_from_host(h, block_k=bk, device=device)
    tiled = tiled_csr_from_host(b, block_k=bk, device=device)
    routes = {
        "dense strips (K1)": (dict(sparse_c=False), cluster_spgemm_windows,
                              cluster_spgemm_windows_plain),
        "CompactedC slabs (K5)": (dict(sparse_c=True),
                                  cluster_spgemm_windows,
                                  cluster_spgemm_windows_plain),
        "padded grid (K6)": (dict(compact=False), cluster_spgemm_padded,
                             lambda g, a, t, c: cluster_spgemm_padded_plain(
                                 g, a, t)),
        "revisit (K7)": (dict(shards=1, revisit=True), cluster_spgemm_revisit,
                         lambda g, a, t, c: cluster_spgemm_revisit_plain(
                             g, a, t)),
        f"{shards} shards (K8)": (dict(shards=shards),
                                  cluster_spgemm_sharded,
                                  cluster_spgemm_sharded_plain),
        f"{shards} shards, revisit (K8)": (dict(shards=shards, revisit=True),
                                           cluster_spgemm_sharded,
                                           cluster_spgemm_sharded_plain),
    }
    cases, base = [], None
    for label, (kw, fn, plain) in routes.items():
        pack = ops.pack_spgemm(bcc, tiled, **kw)
        args = (pack.launch, pack.stream[2], tiled.tiles, pack.cols)
        launches0 = fn.launches
        got, want = fn(*args, pack.census), plain(*args)
        ok, err = nan_equal(got, want), finite_err(got, want)
        if pack.sparse_c:
            got = CompactedC(slabs=got, table=pack.table, nrows=h.nrows,
                             ncols=h.ncols, block_r=8, bn=tiled.bn).to_dense()
        dense = got[:h.nrows, :h.ncols].float()
        if base is None:
            base = dense
        same_as_k1 = nan_equal(dense, base)
        # the live-column visits the walk makes (every live (step, j) of
        # the padded grid, every pair of the others)
        ncol = (pack.cols.col_ptr[1:] - pack.cols.col_ptr[:-1]).long()
        if pack.route == "padded":
            g = pack.launch
            js = torch.arange(g.nnb, device=device)
            live = (g.table[g.tile_ids.long()[:, None] * g.nnb + js]
                    > 0).sum(dim=1)
            visits = int((live * ncol).sum())
        else:
            visits = int(ncol[pack.launch.a_idx.long()].sum())
        case = {"case": f"non-finite B, {label}", "rows": h.nrows,
                "nnz": h.nnz, "block_k": bk, "route": pack.route,
                "non_finite_b_values": 6, "live_column_visits": visits,
                "census_tiles": int(pack.census.numel()),
                "nan": int(dense.isnan().sum()),
                "inf": int(dense.isinf().sum()),
                "max_abs_err": err,
                "tolerance": ("position for position: NaN where the plain "
                              "version is NaN, infs of the same sign, "
                              "finite values equal (torch.equal)"),
                "matched": ok and same_as_k1, "equal_to_plain": ok,
                "equal_to_dense_strips": same_as_k1,
                "compare_launches": fn.launches - launches0}
        log("  case", json.dumps(case))
        if not case["matched"] or case["nan"] == 0:
            raise SystemExit(f"non-finite B: {label} differs from its plain "
                             f"version or from the dense strips")
        cases.append(case)
        del pack, got, want, dense
    return cases


def sparse_linear_layer(rows, cols, tokens, device, rng, *,
                        density=0.1, groups=16, tiles_per_row=10):
    """SparseLinear's weight as ``examples/sparse_ffn.py`` builds it:
    groups of output rows draw their support from a few shared 128-wide
    column tiles (``tiles_per_row`` per row, ``density * cols`` nonzeros
    per row, integer values ±1..3), then the rows are shuffled; pruned
    to ``density``, hierarchically reordered and packed on the device.
    Returns (layer, integer activations (tokens, cols) on the device, the
    same weight packed without the reorder)."""
    import torch
    from repro_torch.models.sparse_linear import SparseLinear
    ntiles = cols // 128
    per_row = int(round(density * cols))
    counts = np.full(tiles_per_row, per_row // tiles_per_row)
    counts[: per_row % tiles_per_row] += 1
    tile_sets = [rng.choice(ntiles, tiles_per_row, replace=False)
                 for _ in range(groups)]
    w = np.zeros((rows, cols), np.float32)
    for i in range(rows):
        for t, cnt in zip(tile_sets[i % groups], counts):
            sel = t * 128 + rng.choice(128, cnt, replace=False)
            w[i, sel] = (rng.integers(1, 4, cnt)
                         * rng.choice([-1, 1], cnt)).astype(np.float32)
    w = w[rng.permutation(rows)]
    t0 = time.perf_counter()
    layer = SparseLinear.from_dense(w, density=density, device=device)
    log(f"  SparseLinear.from_dense({rows} x {cols}, density {density}): "
        f"{time.perf_counter() - t0:.1f} s, stats "
        f"{json.dumps(layer.stats)}")
    x = torch.from_numpy(rng.integers(-2, 3, (tokens, cols)).astype(
        np.float32)).to(device)
    unordered = SparseLinear.from_dense(w, density=density,
                                        reorder="original", device=device)
    return layer, x, unordered


def padded_spmm_case(name, layer, x, device, *, dtype=None, timing=True):
    """The padded-lattice SpMM kernel (K9) at SparseLinear's padded path:
    the packed weight against the activations' transpose (fp32, or cast
    to a 16-bit ``dtype``: the integer activations stay exact, the output
    is rounded after every slot in both versions), launched with the
    layer's panel schedule. Prints the panels' distinct B tiles per slot
    and the B bytes the panels stage (modelled: every entry's tile rows
    once per column strip) against those of one block per CTA."""
    import torch
    from repro_torch.kernels.cluster_spmm import (KERNEL_MAX_BN,
                                                  cluster_spmm,
                                                  cluster_spmm_plain)
    launches0 = cluster_spmm.launches
    bcc = layer.bcc
    xt = x.T.contiguous().to(dtype or torch.float32)   # (in, tokens)
    esize = xt.element_size()
    kw = dict(block_r=bcc.block_r, block_k=bcc.block_k,
              tiles_per_block=bcc.tiles_per_block)
    bn = min(KERNEL_MAX_BN, max(8, xt.shape[1]))
    panels = layer.panels
    run = lambda: cluster_spmm(bcc.tile_ids, bcc.values, xt,  # noqa: E731
                               bn=bn, panels=panels, **kw)
    plain = lambda: cluster_spmm_plain(  # noqa: E731
        bcc.tile_ids, bcc.values, xt, **kw)
    got, want = run(), plain()
    ok = bool(torch.equal(got, want)) and got.dtype == xt.dtype
    err = float((got.float() - want.float()).abs().max())
    ms = timed_ms(run, device) if timing else None
    device_ms = (kernel_device_ms(run, device, "spmm_panel_kernel")
                 if timing else None)
    plain_ms = timed_ms(plain, device, reps=3) if timing else None
    # the yardstick: cuSPARSE's CSR × dense on the packed weight
    dense_w = bcc.to_dense().to(xt.dtype)
    wc = dense_w.to_sparse_csr()
    del dense_w
    lib_ms = (library_ms(lambda: torch.sparse.mm(wc, xt), device)
              if timing else None)
    # the bound: the product's true flops (2 per weight nonzero per
    # token), the CSR weight, the activations and the result once each.
    # The products are fp32 whatever B's dtype: the weight is fp32, and
    # the reference promotes fp32 × 16-bit to fp32
    nnz = int(wc.values().numel())
    tokens = xt.shape[1]
    true_flops = 2 * nnz * tokens
    bound_ms, bound_by = bound(
        csr_bytes(layer.out_features, nnz) + esize * xt.numel()
        + esize * layer.out_features * tokens, true_flops)
    slabs = bcc.values.shape[0]
    # B's bytes staged: each (panel, slot) entry's tile rows (those below
    # K) across all column strips, against one block per CTA
    tile_rows = min(bcc.block_k, xt.shape[0])
    per_tile = tile_rows * tokens * esize
    b_bytes = panels.nentries * per_tile
    b_bytes_per_block = slabs * per_tile
    tile_flops = 2 * slabs * bcc.block_r * bcc.block_k * tokens
    tile_bound_ms, tile_bound_by = bound(
        4 * bcc.values.numel() + esize * xt.numel() + esize * got.numel()
        + 4 * slabs, tile_flops)
    case = {"case": name, "dtype": str(xt.dtype),
            "weight": [layer.out_features, layer.in_features],
            "weight_nnz": nnz, "tokens": tokens, "block_k": bcc.block_k,
            "nblocks": bcc.nblocks, "tiles_per_block": bcc.tiles_per_block,
            "live_tiles": layer.stats["live_tiles"], "slabs": slabs,
            "panels": panels.npanels, "panel_entries": panels.nentries,
            "blocks_per_panel": bcc.nblocks / panels.npanels,
            "tiles_per_panel_slot": panels.tiles_per_slot,
            "modelled_b_bytes": b_bytes,
            "modelled_b_bytes_one_block_per_cta": b_bytes_per_block,
            "b_bytes_ratio": b_bytes / b_bytes_per_block,
            "true_flops": true_flops, "tile_flops": tile_flops,
            "max_abs_err": err, "tolerance": "exact (torch.equal)",
            "matched": ok, "ms": ms, "kernel_device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR weight + activations + result "
                           "once / 3.35 TB/s, 2*nnz*tokens flops / "
                           "67 TFLOP/s fp32)"),
            "tile_bound_ms": tile_bound_ms, "tile_bound_by": tile_bound_by,
            "tile_bound_rule": ("max(bytes: slabs + activations + result + "
                                "tile ids once / 3.35 TB/s, padded fp32 FMAs "
                                "2*slabs*8*block_k*tokens / 67 TFLOP/s)"),
            "library": "torch.sparse.mm(csr weight, dense activations)",
            "library_ms": lib_ms,
            "compare_launches": cluster_spmm.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"padded SpMM kernel disagrees with its plain "
                         f"version on {name}: max abs err {err}")
    return case


def linear_compact_case(name, layer, x, device, *, dtype=None,
                        timing=True):
    """The compact SpMM kernel (K4) at SparseLinear's default path: the
    layer's kept compact stream and live columns (built once with the
    layer) against the activations' transpose. Its slabs are dense — every
    column live — the live-column form's worst case; K9's padded-lattice
    kernel on the same slabs is timed beside it. ``dtype``: the
    activations cast to bf16 or fp16 (exact on these integers; the output
    rounded after every step in both versions)."""
    import torch
    from repro_torch.kernels.cluster_spmm import (
        KERNEL_MAX_BN, cluster_spmm, cluster_spmm_compact,
        cluster_spmm_compact_plain)
    launches0 = cluster_spmm_compact.launches
    bcc = layer.bcc
    (block_ids, tile_ids, a_vals), cols = layer.stream, layer.cols
    bids = torch.from_numpy(block_ids).to(device)
    tids = torch.from_numpy(tile_ids).to(device)
    xt = x.T.contiguous().to(dtype or torch.float32)   # (in, tokens)
    esize = xt.element_size()
    tokens = xt.shape[1]
    kw = dict(block_r=bcc.block_r, block_k=bcc.block_k, nblocks=bcc.nblocks)
    bn = min(KERNEL_MAX_BN, tokens)
    run = lambda: cluster_spmm_compact(bids, tids, a_vals, xt,  # noqa: E731
                                       bn=bn, cols=cols, **kw)
    plain = lambda: cluster_spmm_compact_plain(  # noqa: E731
        bids, tids, a_vals, xt, cols=cols, **kw)
    got, want = run(), plain()
    ok = bool(torch.equal(got, want)) and got.dtype == xt.dtype
    err = float((got.float() - want.float()).abs().max())
    ms = timed_ms(run, device) if timing else None
    device_ms = (kernel_device_ms(run, device, "spmm_columns_kernel")
                 if timing else None)
    # what finding a dead column's non-finite value costs on finite data:
    # the tile marks and the count of B's non-finite values
    repair_ms = (kernel_device_ms(run, device, SPMM_CENSUS_KERNELS)
                 if timing else None)
    plain_ms = timed_ms(plain, device, reps=3) if timing else None
    # K9 on the same (pad-free) slabs: the tile-padded body this kernel
    # replaced on the compact stream
    padded_ms = (timed_ms(lambda: cluster_spmm(
        bcc.tile_ids, bcc.values, xt, block_r=bcc.block_r,
        block_k=bcc.block_k, tiles_per_block=bcc.tiles_per_block,
        bn=min(KERNEL_MAX_BN, max(8, tokens))), device)
        if timing else None)
    dense_w = bcc.to_dense().to(xt.dtype)
    wc = dense_w.to_sparse_csr()
    del dense_w
    nnz = int(wc.values().numel())
    lib_ms = (library_ms(lambda: torch.sparse.mm(wc, xt), device)
              if timing else None)
    # fp32 products whatever B's dtype (the weight is fp32), as in K9's
    bound_ms, bound_by = bound(
        csr_bytes(layer.out_features, nnz) + esize * xt.numel()
        + esize * layer.out_features * tokens, 2 * nnz * tokens)
    work = spmm_work(cols, tids, bcc.block_k, tokens, got.numel() * esize,
                     row_bytes=esize * tokens)
    case = {"case": name, "dtype": str(xt.dtype),
            "weight": [layer.out_features, layer.in_features],
            "weight_nnz": nnz, "tokens": tokens, "block_k": bcc.block_k,
            "steps": int(a_vals.shape[0]),
            "dense_slab_columns": int(a_vals.shape[0]) * bcc.block_k,
            "true_flops": 2 * nnz * tokens, "max_abs_err": err,
            "tolerance": "exact (torch.equal)", "matched": ok, "ms": ms,
            "kernel_device_ms": device_ms,
            "non_finite_check_device_ms": repair_ms, "plain_ms": plain_ms,
            "padded_lattice_kernel_ms": padded_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rule": ("max(bytes: CSR weight + activations + result "
                           "once / 3.35 TB/s, 2*nnz*tokens flops / "
                           "67 TFLOP/s fp32)"), **work,
            "library": "torch.sparse.mm(csr weight, dense activations)",
            "library_ms": lib_ms,
            "compare_launches": cluster_spmm_compact.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"compact SpMM kernel disagrees with its plain "
                         f"version on {name}: max abs err {err}")
    return case


FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-5


def flash_case(name, bh, s, d, device, *, dtype=None, timing=True):
    """The flash-attention kernel (K10) on (bh, s, d) causal inputs from a
    seeded generator (fp32, or cast to ``dtype``), against its plain
    version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_tolerance)
    dtype = dtype or torch.float32
    launches0 = flash_attention.launches
    g = torch.Generator(device=device).manual_seed(bh * s + d)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=device).to(dtype)
               for _ in range(3))
    run = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: flash_attention_plain(q, k, v, causal=True)  # noqa
    got, want = run(), plain()
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        ok = bool(torch.allclose(got, want, rtol=FLASH_RTOL,
                                 atol=FLASH_ATOL))
        tolerance = (f"|kernel-plain| <= {FLASH_ATOL:g} + {FLASH_RTOL:g} "
                     "|plain| (fp32 summation order)")
    else:
        tol = flash_attention_tolerance(q, k, v, want, causal=True)
        excess = float(((got.float() - want.float()).abs() / tol).max())
        ok = got.dtype == dtype and excess <= 1.0
        tolerance = (f"per element |kernel-plain| <= 3u((P|V|)/l + |plain|),"
                     f" u the unit roundoff of {dtype}, P and l in fp32 "
                     f"(largest share of it used: {excess:.3f})")
        del tol
    ms = timed_ms(run, device) if timing else None
    device_ms = (kernel_device_ms(run, device, "flash_kernel")
                 if timing else None)
    plain_ms = timed_ms(plain, device) if timing else None
    # the bound: QKᵀ and PV on the causal pairs (q_pos >= k_pos) of each
    # head, 2 flops per multiply-add; Q, K, V read and O written once
    pairs = s * (s + 1) // 2
    flops = 4 * bh * pairs * d
    # the rate of q, k, v's type: 16-bit operands could run on the tensor
    # cores (the kernel keeps to the fp32 CUDA cores)
    peak, rate = ((PEAK_FP32_FLOPS, "fp32") if dtype == torch.float32
                  else (PEAK_16_FLOPS, "16-bit tensor cores"))
    bound_ms, bound_by = bound(4 * q.element_size() * bh * s * d, flops,
                               peak)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], k[None], v[None], is_causal=True)
    lib_ms = library_ms(lib, device) if timing else None
    case = {"case": name, "shape": [bh, s, d], "dtype": str(dtype),
            "causal": True, "causal_pairs_per_head": pairs, "flops": flops,
            "max_abs_err": err, "tolerance": tolerance,
            "matched": ok, "ms": ms, "kernel_device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rule": ("max(bytes: Q, K, V, O once / 3.35 TB/s, "
                           f"4*D per causal pair / {peak / 1e12:g} TFLOP/s "
                           f"{rate})"),
            "library": ("torch.nn.functional.scaled_dot_product_attention("
                        "is_causal=True)"),
            "library_ms": lib_ms,
            "compare_launches": flash_attention.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"flash-attention kernel disagrees with its plain "
                         f"version on {name}: max abs err {err}")
    return case


SSD_TOL = 1e-4
# the SSD kernel's launches, one name per pass (the scores pass only when
# heads share a group)
SSD_PASSES = ("ssd_chunk_scores_kernel", "ssd_chunk_states_kernel",
              "ssd_chunk_recur_kernel", "ssd_chunk_out_kernel")


def ssd_case(name, bh, nc, q, p, n, device, *, rep=1, timing=True):
    """The SSD chunk-scan kernel (K11) on (bh, nc, q, p/n) fp32 inputs
    from a seeded generator (log-decays in (-0.3, 0], as dt-scaled
    -exp(A_log) gives them), B and C per head (``rep`` = 1, the JAX
    kernel's interface) or per group of ``rep`` heads (as ``fused_ssd``
    passes them), against its plain version."""
    import torch
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan,
                                               ssd_chunk_scan_plain)
    launches0 = ssd_chunk_scan.launches
    g = torch.Generator(device=device).manual_seed(bh * q + n)
    x = torch.randn((bh, nc, q, p), generator=g, device=device) * 0.3
    a = -torch.rand((bh, nc, q), generator=g, device=device) * 0.3
    b, c = (torch.randn((bh // rep, nc, q, n), generator=g, device=device)
            for _ in range(2))
    run = lambda: ssd_chunk_scan(x, a, b, c,  # noqa: E731
                                 heads_per_group=rep)
    plain = lambda: ssd_chunk_scan_plain(x, a, b, c,  # noqa: E731
                                         heads_per_group=rep)
    (y, h), (y0, h0) = run(), plain()
    err = max(float((y - y0).abs().max()), float((h - h0).abs().max()))
    scale = max(1.0, float(y0.abs().max()), float(h0.abs().max()))
    ok = err <= SSD_TOL * scale
    passes = SSD_PASSES if rep > 1 else SSD_PASSES[1:]
    ms = timed_ms(run, device) if timing else None
    split = (kernel_device_ms(run, device, passes, split=True)
             if timing else None)
    device_ms = split.pop("total") if split else None
    plain_ms = timed_ms(plain, device) if timing else None
    # the bound: per (bh, chunk) C·Bᵀ and the decayed product with X on
    # the lower triangle, the readout C·h and the state update, 2 flops
    # per multiply-add; x, a, b, c read and y, h written once. Heads that
    # share a group share its C·Bᵀ: computed once per (group, chunk)
    pairs = q * (q + 1) // 2
    flops = 2 * bh * nc * (pairs * (n + p) + 2 * q * n * p)
    shared_flops = (2 * (bh // rep) * nc * pairs * n
                    + 2 * bh * nc * (pairs * p + 2 * q * n * p))
    nbytes = 4 * (2 * x.numel() + a.numel() + 2 * b.numel() + h.numel())
    bound_ms, bound_by = bound(nbytes, flops)
    shared_ms, shared_by = bound(nbytes, shared_flops)
    case = {"case": name, "shape": {"bh": bh, "nc": nc, "q": q, "p": p,
                                    "n": n, "heads_per_group": rep},
            "flops": flops, "bytes": nbytes, "max_abs_err": err,
            "tolerance": (f"max|kernel-plain| <= {SSD_TOL:g} x max(1, "
                          "max|plain|) (fp32 summation order)"),
            "matched": ok, "ms": ms, "kernel_device_ms": device_ms,
            "pass_device_ms": split,
            "pass_share": ({k: v / device_ms for k, v in split.items()}
                           if split else None),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_rule": ("max(bytes: x, a, b, c, y, h once / 3.35 TB/s, "
                           "2*(pairs*(N+P) + 2*Q*N*P) per (bh, chunk) / "
                           "67 TFLOP/s fp32)"),
            "shared_scores_flops": shared_flops,
            "shared_scores_bound_ms": shared_ms,
            "shared_scores_bound_by": shared_by,
            "shared_scores_bound_rule": ("the same with C·Bᵀ (2*pairs*N) "
                                         "once per (group, chunk)"),
            "library": None, "library_ms": None,
            "compare_launches": ssd_chunk_scan.launches - launches0}
    log("  case", json.dumps(case))
    if not ok:
        raise SystemExit(f"SSD chunk-scan kernel disagrees with its plain "
                         f"version on {name}: max abs err {err}")
    return case


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
    # the kept packs of the window and SpMM routes carry A's live columns
    # (built once per packed operand); the padded grid reads slabs
    kinds = {}
    for e, _ in planner._exec_cache.values():
        if e[0] == "spmm_pallas":
            kind, cols = e[0], e[3]
        elif e[0] in ("pallas", "chain"):
            kind, cols = f"{e[0]}:{e[2].route}", e[2].cols
        else:
            continue
        kinds.setdefault(kind, []).append(cols is not None)
    held["live_columns_kept"] = {k: all(v) for k, v in kinds.items()}
    log("  exec cache", json.dumps(held))
    if held["exec_bytes"] > held["exec_cap_bytes"]:
        raise SystemExit(f"exec cache over its byte cap: {held}")
    if not all(ok for k, ok in held["live_columns_kept"].items()
               if not k.endswith(":padded")):
        raise SystemExit(f"a kept pack lacks its live columns: {held}")
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


def sparse_linear_phase(layer, x, device):
    """SparseLinear's two kernel paths: ``apply(x, compact=False)`` (the
    padded lattice, the entry point of K9) and ``apply(x)`` (the compact
    stream's live columns, K4, kept with the layer), once each, counters
    zeroed just before and read just after each; both results must equal
    the dense pruned product. Returns K9's count (K4's main-path count is
    the SpMM request's)."""
    from repro_torch.device import synchronize
    from repro_torch.kernels.cluster_spmm import (cluster_spmm,
                                                  cluster_spmm_compact)
    want = layer.apply(x, use_kernel=False)
    launches = {}
    for compact, fn in ((False, cluster_spmm), (True, cluster_spmm_compact)):
        fn.launches = 0
        t0 = time.perf_counter()
        y = layer.apply(x, compact=compact)
        synchronize(device)
        wall = time.perf_counter() - t0
        count = {fn.__name__: fn.launches}
        exact = bool((y == want).all())
        log("  call", json.dumps({"SparseLinear.apply": {"compact": compact},
                                  "out_shape": list(y.shape), "wall_s": wall,
                                  "exact_vs_dense_pruned": exact,
                                  "launches": count}))
        if not exact:
            raise SystemExit(f"SparseLinear.apply(compact={compact}) "
                             "differs from the dense pruned product")
        if device.type == "cuda" and count != {fn.__name__: 1}:
            raise SystemExit(f"launch counts off SparseLinear's path: "
                             f"{count}")
        if not compact:
            launches.update(count)
    non_finite_check(layer, x, device)
    return launches


def non_finite_check(layer, x, device):
    """``SparseLinear.apply(x)`` (the compact path, K4) on activations
    holding an inf at a feature that is a dead column of some slab (all 8
    of its weights zero), a -inf and a NaN: equal to the plain version
    position for position (NaN where it is NaN, inf of the same sign,
    equal finite values), and the dead column's inf must make its block's
    outputs NaN, as the JAX package's whole-slab product does."""
    import torch
    from repro_torch.device import synchronize
    from repro_torch.kernels.cluster_spmm import cluster_spmm_compact_plain
    block_ids, tile_ids, vals = layer.stream
    cols, bk = layer.cols, layer.bcc.block_k
    ptr = cols.col_ptr.cpu().numpy()
    short = np.flatnonzero(np.diff(ptr) < bk)
    feature = step = None
    for s_ in short:
        live = set(cols.col_k[ptr[s_]:ptr[s_ + 1]].cpu().tolist())
        dead = [k for k in range(bk) if k not in live
                and int(tile_ids[s_]) * bk + k < layer.in_features]
        if dead:
            step, feature = int(s_), int(tile_ids[s_]) * bk + dead[0]
            break
    if feature is None:
        raise SystemExit("SparseLinear layer has no dead slab column")
    xb = x.clone()
    tokens = xb.shape[0]
    xb[0, feature] = float("inf")
    xb[tokens // 2, (feature + 1) % layer.in_features] = float("-inf")
    xb[tokens - 1, (feature + 7) % layer.in_features] = float("nan")
    t0 = time.perf_counter()
    y = layer.apply(xb)
    synchronize(device)
    wall = time.perf_counter() - t0
    # the plain version on the same stream and columns, un-permuted as
    # apply un-permutes
    dev = xb.device
    xt = xb.T.contiguous()
    packed = cluster_spmm_compact_plain(
        torch.from_numpy(np.asarray(block_ids)).to(dev),
        torch.from_numpy(np.asarray(tile_ids)).to(dev), vals, xt,
        block_r=layer.bcc.block_r, block_k=bk, nblocks=layer.bcc.nblocks,
        cols=cols)[:layer.bcc.nrows]
    inv = torch.from_numpy(np.argsort(layer.perm)).to(dev)
    want = packed[inv].T
    same = bool(((y == want) | (y.isnan() & want.isnan())).all())
    blk = int(block_ids[step])
    rows = [int(layer.perm[r]) for r in range(blk * 8, min(blk * 8 + 8,
                                                           layer.bcc.nrows))]
    reached = bool(y[0, rows].isnan().all())
    log("  non-finite", json.dumps({
        "SparseLinear.apply": {"compact": True},
        "dead_column_feature": feature, "block": blk, "wall_s": wall,
        "nan": int(y.isnan().sum()), "inf": int(y.isinf().sum()),
        "equal_to_plain": same, "dead_column_reaches_its_block": reached}))
    if not (same and reached):
        raise SystemExit("SparseLinear.apply on non-finite activations "
                         "differs from the plain version")


LOGIT_TOL = 2e-3


def lm_phase(device, *, rehearse):
    """zamba2-2.7b served through ``run_serving`` (its published size on
    the card; the smoke config in the rehearsal): the prefill's kernel
    launches counted, greedy tokens checked against the vocabulary; then
    the same weights and prompts prefilled through the kernels (profiled)
    and through the model's own chunked path, whose logits must agree."""
    import torch
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.transformer import init_params, prefill
    from repro_torch.serve.engine import make_serve_step
    arch, seed = "zamba2-2.7b", 0
    cfg = smoke_config(arch) if rehearse else get_config(arch)
    batch, prompt_len, gen = (2, 64, 8) if rehearse else (4, 1024, 32)
    log(f"  config {cfg.name}: {cfg.num_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, shared attention after every "
        f"{cfg.hybrid_attn_every} ({cfg.num_heads} heads of "
        f"{cfg.head_dim}), ssm_state {cfg.ssm_state}, "
        f"{cfg.ssm_num_heads} SSM heads of {cfg.ssm_head_dim}, chunk "
        f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}; "
        f"{cfg.param_count():,} parameters "
        f"({cfg.param_count() * 4 / 1e9:.2f} GB fp32)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the main path's run: counters zeroed just before, read just after
    flash_attention.launches = 0
    ssd_chunk_scan.launches = 0
    t0 = time.perf_counter()
    out = run_serving(arch, smoke=rehearse, batch=batch,
                      prompt_len=prompt_len, gen=gen, seed=seed,
                      device=device, use_pallas=True)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssd_chunk_scan": ssd_chunk_scan.launches}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    toks = out["tokens"]
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    row = {"arch": arch, "params": cfg.param_count(), "batch": batch,
           "prompt_len": prompt_len, "gen": gen,
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "decode_tok_per_s": out["decode_tok_per_s"],
           "prefill_tok_per_s": batch * prompt_len / out["prefill_s"],
           "run_serving_wall_s": wall, "launches_per_prefill": launches,
           "expected_launches": {"flash_attention": cfg.num_attn_layers,
                                 "ssd_chunk_scan": cfg.num_layers},
           "tokens_shape": list(toks.shape), "tokens_in_vocab": in_vocab,
           "sample_tokens": toks[0][:8].tolist(),
           "peak_device_bytes": peak}
    log("  serving", json.dumps(row))
    if not in_vocab or toks.shape != (batch, gen):
        raise SystemExit(f"greedy tokens off the vocabulary: {row}")
    if device.type == "cuda" and launches != row["expected_launches"]:
        raise SystemExit(f"launch counts off the LM prefill: {launches}")
    del out

    # the same weights and prompts (run_serving's seed), prefilled through
    # the kernels and through the model's own chunked path
    params = init_params(cfg, seed, device=device)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(device)
    max_len = prompt_len + gen
    profile = device.type == "cuda"
    ctx = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
        if profile else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        kern, cache = prefill(cfg, params, {"tokens": tokens}, max_len,
                              use_pallas=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        kern_s = time.perf_counter() - t0
    kern = kern[..., : cfg.vocab_size].clone()
    nxt = kern[:, -1].argmax(-1)[:, None]
    t0 = time.perf_counter()
    chunked, _ = prefill(cfg, params, {"tokens": tokens}, max_len,
                         use_pallas=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    chunked_s = time.perf_counter() - t0
    chunked = chunked[..., : cfg.vocab_size]
    finite = bool(torch.isfinite(kern).all() and torch.isfinite(chunked).all())
    err = float((kern - chunked).abs().max())
    scale = float(chunked.abs().max())
    same_argmax = float((kern.argmax(-1) == chunked.argmax(-1)).float().mean())
    per_kernel = None
    busy = None
    if profile:
        busy, _ = device_time(prof)
        per_kernel = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                for key, tag in (("flash_attention", "flash_kernel"),
                                 ("ssd_chunk_scan", "ssd_chunk_")):
                    if tag in ev.name:
                        ms, cnt = per_kernel.get(key, (0.0, 0))
                        per_kernel[key] = (
                            ms + ev.time_range.elapsed_us() / 1e3, cnt + 1)
        per_kernel = {k: {"device_ms": v[0], "launches": v[1]}
                      for k, v in per_kernel.items()}
    # one decode step after the kernel prefill, profiled: how much of a
    # step the card is busy
    step = make_serve_step(cfg)
    step(params, cache, {"tokens": nxt})           # warm-up
    with (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
          if profile else contextlib.nullcontext()) as dprof:
        t0 = time.perf_counter()
        step(params, cache, {"tokens": nxt})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s = time.perf_counter() - t0
    step_busy, step_top = device_time(dprof) if profile else (None, None)
    step_events = (sum(1 for ev in dprof.events() if ev.device_type
                       == torch.autograd.DeviceType.CUDA)
                   if profile else None)
    del cache
    check = {"kernel_prefill_s": kern_s, "chunked_prefill_s": chunked_s,
             "prefill_device_busy_s": busy,
             "kernel_device_time": per_kernel,
             "max_abs_logit_diff": err, "max_abs_logit": scale,
             "tolerance": (f"max|kernel - chunked| <= {LOGIT_TOL:g} x "
                           "max|chunked| over the real vocabulary"),
             "argmax_agreement": same_argmax, "finite": finite,
             "decode_step_s": step_s, "decode_step_device_busy_s": step_busy,
             "decode_step_device_events": step_events,
             "decode_step_device_top_ms": step_top}
    log("  kernel vs chunked prefill", json.dumps(check))
    if not finite or not err <= LOGIT_TOL * scale:
        raise SystemExit(f"kernel prefill disagrees with the chunked path: "
                         f"{check}")
    return launches, row, check


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
        raise SystemExit("no CUDA device available")
    try:
        from repro_torch.core import suite
        from repro_torch.core.formats import HostCSR
        from repro_torch.kernels import _build
    except ImportError as e:
        raise SystemExit(f"the port is not importable ({e}); run from the "
                         "repository root") from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"  IEEE fp32 matmuls: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")

    # -- phase 1: environment ------------------------------------------------
    if args.rehearse:
        device = torch.device("cpu")
        smi = "rehearsal on the CPU"
        phase("phase 1: rehearsal on the CPU (no card, no kernel build)")
    else:
        device = torch.device("cuda")
        smi = nvidia_smi_line()
        phase("phase 1: environment")
        log(f"  gpu: {smi}")
        log(f"  torch {torch.__version__}, cuda {torch.version.cuda}, "
            f"python {sys.version.split()[0]}")
        build_s, build_logs = _build.build_all()
        log(f"  kernel build: {build_s:.2f} s ({len(build_logs)} sources, "
            "one nvcc each, in parallel)")
        for name, text in build_logs.items():
            for line in ptxas_report(text):
                log(f"    {name}: {line}")
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
        nonfinite_h = suite.gen_kron(8, 16, seed=0)
        cave = suite.gen_caveman(4096, 24, seed=0)
        plaw = suite.gen_powerlaw(512, 12, seed=3)
        # still wider than the live-pair grid's strip budget (65,536)
        mesh, wide_rows = suite.gen_mesh2d(258, seed=0, stencil=5), 256
        spmm_cols, ragged_cols = 16, 10
        # SparseLinear weight (rows, cols), tokens; attention (BH, S, D);
        # SSD (BH, nc, Q, P, N)
        linear = (96, 1280, 64)
        flash_shapes = [(4, 128, 80, "float32"), (2, 100, 80, "float32"),
                        (2, 64, 128, "float32"), (2, 64, 160, "float32"),
                        (4, 128, 80, "bfloat16"), (4, 128, 80, "float16")]
        ssd_shapes = [(8, 4, 64, 16, 16, 1), (8, 4, 64, 16, 16, 4),
                      (8, 1, 75, 16, 16, 1)]
    else:
        kron = suite.gen_kron(14, 16, seed=0)
        nonfinite_h = suite.gen_kron(12, 16, seed=0)
        cave = suite.gen_caveman(16384, 24, seed=0)
        plaw = suite.generate(next(s for s in suite.SUITE
                                   if s.name == "plaw_4096_12"))
        mesh, wide_rows = suite.gen_mesh2d(288, seed=0, stencil=5), 8192
        spmm_cols, ragged_cols = 64, 40
        # zamba2-2.7b: d_model 2560 × d_ff 10240 at 4 × 1024 tokens;
        # B·Hq = 4 × 32 heads of 80 at S = 1024; B·H = 4 × 80 SSM heads,
        # 4 chunks of 256, P = N = 64
        linear = (2560, 10240, 4096)
        # (BH, S, D, dtype): the prefill's shape, a ragged S, D = 128 and
        # D = 160 (the 32-key-block instantiation), and the prefill's shape
        # in bf16 and fp16
        flash_shapes = [(128, 1024, 80, "float32"), (128, 1000, 80, "float32"),
                        (64, 1024, 128, "float32"), (32, 1024, 160, "float32"),
                        (128, 1024, 80, "bfloat16"),
                        (128, 1024, 80, "float16")]
        # (…, heads per group): per head as the JAX kernel takes B and C,
        # then zamba2-2.7b's one group for its 80 heads, as fused_ssd
        # passes them
        ssd_shapes = [(320, 4, 256, 64, 64, 1), (320, 4, 256, 64, 64, 80),
                      (320, 1, 300, 64, 64, 1)]
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
    phase("phase 2: kernels against their plain versions")
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
    spmm_cave = spmm_case("compact SpMM, dense B (caveman)", cave_i,
                          spmm_cols, device, rng, timing=timing)
    spmm_plaw = spmm_case("compact SpMM, block_k=512 (powerlaw)",
                          integer_valued(plaw, rng), spmm_cols, device, rng,
                          timing=timing)
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
    # a B of 256 columns: nnb = 2, so 256-block revisit windows, each cut
    # into 4-block segments for the kernel's shared-memory accumulator
    narrow_streams = stream_cases(
        "kron x its first 256 columns", kron_i, device, [(1, True)],
        b=first_columns(kron_i, 256), timing=timing)
    stream_all = kron_streams + cave_streams + narrow_streams
    # inf, -inf and NaN in B: every Sp x Sp kernel against its plain
    # version, position for position
    nonfinite = nonfinite_spgemm_case(
        integer_valued(nonfinite_h, rng), device, rng)
    lin_layer, lin_x, lin_unordered = sparse_linear_layer(*linear, device,
                                                          rng)
    padded_spmm = padded_spmm_case(
        "padded-lattice SpMM, SparseLinear d_model x d_ff weight",
        lin_layer, lin_x, device, timing=timing)
    # the paper's point: the same weight packed without the clustering
    # reorder (more live tiles, blocks that share few of them)
    padded_unordered = padded_spmm_case(
        "padded-lattice SpMM, the same weight without the clustering reorder",
        lin_unordered, lin_x, device, timing=timing)
    del lin_unordered
    linear_compact = linear_compact_case(
        "compact SpMM, SparseLinear d_model x d_ff weight (dense slabs)",
        lin_layer, lin_x, device, timing=timing)
    # the 16-bit variants: bf16 and fp16 activations, rounded per step
    linear_16 = []
    for dt in (torch.bfloat16, torch.float16):
        linear_16.append(padded_spmm_case(
            f"padded-lattice SpMM, SparseLinear weight, {dt} activations",
            lin_layer, lin_x, device, dtype=dt, timing=timing))
        linear_16.append(linear_compact_case(
            f"compact SpMM, SparseLinear weight, {dt} activations",
            lin_layer, lin_x, device, dtype=dt, timing=timing))
    flash_cases = [flash_case(
        f"flash attention causal (BH={bh}, S={sq}, D={d}, {dt})", bh, sq, d,
        device, dtype=getattr(torch, dt), timing=timing)
        for bh, sq, d, dt in flash_shapes]
    ssd_cases = [ssd_case(
        f"SSD chunk scan (BH={bh}, nc={nc}, Q={q}, P={p}, N={n}, "
        f"{rep} heads per group)", bh, nc, q, p, n, device, rep=rep,
        timing=timing)
        for bh, nc, q, p, n, rep in ssd_shapes]

    # -- phase 3: the serving path ---------------------------------------------
    phase("phase 3: SpGEMMServer.submit with seeded pallas plans")
    launches, _ = serve_phase(mats, device, rng, spmm_cols)
    phase("phase 3b: bcc_spgemm_tiled(shards=..., revisit=...) on kron")
    launches.update(sharded_phase(kron_i, device, sm_count))
    phase("phase 3c: SparseLinear.apply(compact=False), apply(x), and apply "
        "on non-finite activations")
    launches.update(sparse_linear_phase(lin_layer, lin_x, device))
    del lin_layer, lin_x
    # the SpGEMM phases' device memory is released before the LM phase
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        log(f"  device memory held before the LM phase: "
            f"{torch.cuda.memory_allocated(device) / 1e9:.3f} GB")
    phase("phase 3d: LM serving, run_serving('zamba2-2.7b')")
    lm_launches, _, _ = lm_phase(device, rehearse=args.rehearse)
    launches.update(lm_launches)

    # -- phase 4: summary ------------------------------------------------------
    win_cases = [dense, slab, tall, bf16] + nonfinite[:2]
    spmm_cases = [spmm, ragged, spmm_cave, spmm_plaw, linear_compact,
                  linear_16[1], linear_16[3]]
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
                "ms": main["ms"],
                "kernel_device_ms": main.get("kernel_device_ms"),
                "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "tile_bound_ms": main.get("tile_bound_ms"),
                "work_bound_ms": main.get("work_bound_ms"),
                "slab_columns_ms": main.get("slab_columns_ms"),
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
              [padded, padded_bf16, nonfinite[2]], padded),
        entry("cluster_spgemm_revisit",
              "src/repro_torch/kernels/csrc/cluster_spgemm_revisit.cu",
              "src/repro/kernels/cluster_spgemm.py:537 (K7 "
              "cluster_spgemm_pairs_window)", revisit_cases + nonfinite[3:4],
              revisit_cases[0]),
        entry("cluster_spgemm_sharded",
              "src/repro_torch/kernels/csrc/cluster_spgemm.cu",
              "src/repro/kernels/cluster_spgemm.py:594 (K8 "
              "cluster_spgemm_pairs_sharded, the shard_map dispatch; "
              "window_kernel here, segment_kernel in "
              "csrc/cluster_spgemm_revisit.cu)", sharded_cases + nonfinite[4:],
              sharded_main),
        entry("cluster_spmm",
              "src/repro_torch/kernels/csrc/cluster_spmm.cu",
              "src/repro/kernels/cluster_spmm.py:103 (K9 cluster_spmm, "
              "the padded grid)", [padded_spmm, padded_unordered,
                                   linear_16[0], linear_16[2]],
              padded_spmm),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cuh",
              "src/repro/kernels/flash_attention.py:87 (K10 "
              "flash_attention)", flash_cases, flash_cases[0]),
        entry("ssd_chunk_scan",
              "src/repro_torch/kernels/csrc/ssd_chunk.cu",
              "src/repro/kernels/ssd_chunk.py:94 (K11 ssd_chunk_scan)",
              ssd_cases, ssd_cases[0]),
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


def run(argv=None) -> int:
    """:func:`main`, with every failure before the last line reported on
    stdout as one line naming the phase and the error (a traceback goes
    to stderr), and a non-zero exit code."""
    try:
        return main(argv)
    except SystemExit as e:
        if e.code in (None, 0):
            return 0
        if isinstance(e.code, int):     # argparse's usage errors
            log(f"chip_smoke: failed in {PHASE}: exit code {e.code}")
            return e.code
        log(f"chip_smoke: failed in {PHASE}: {e.code}")
        return 1
    except Exception as e:  # noqa: BLE001 - reported, then exit 1
        import traceback
        traceback.print_exc()
        log(f"chip_smoke: failed in {PHASE}: {type(e).__name__}: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(run())
