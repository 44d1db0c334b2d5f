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
   causal, a ragged S = 1000, a D = 128 case, and phase 3g's prefill
   shapes: qwen3-14b's (160, 1024, 128) and granite-moe-3b's
   (96, 1024, 64)) and the SSD chunk-scan
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
3e. the async front-end — ``AsyncSpGEMMServer`` (``workers=0``, the
   script pumps) serving a burst of 32 distinct, seeded, integer-valued
   square members of 256 rows (kron, caveman, powerlaw and 2-D mesh
   patterns, eight seeds each, interleaved), pallas plans seeded for
   every pack (``workload="batch"``) and every member: (a) batched — four
   block-diagonal batches of eight, one window-kernel launch per batch,
   every response ``batched`` with ``batch_size`` 8, none degraded (then
   again with fresh values, profiled), and the window kernel on the first
   pack against its plain version; (b) unbatched — one launch per
   request; (c) eight sparse A·B pairs (B of twice the columns) as one
   batch; (d) a ``kernel_launch`` fault on the batched launch: the batch
   disbands once and its members are re-served one by one, the first on
   the ladder's ``fixed`` rung; (e) four worker threads on the same
   members with fresh values; (f) no seeded plans, the cold packs' scheme
   printed, not asserted; (g) the first batch's members with non-integer
   values, batched and unbatched, within 1e-5 of the largest value (bit
   identity printed). Every launch counter is zeroed just before each
   run and read just after, every ticket must equal scipy's product, and
   each run prints its wall time, summed ``plan_s`` and ``execute_s``,
   launches, routes and launch amortization (profiled runs: device time
   and the window kernel's own; run (a): the pack's dense-C copy and
   float64 guard);
3f. the measurement tier and the kernel tier's prior — (a)
   ``benchlib``'s sweep on the card over the JAX quick tier's shape
   (``representative_subset(8)``, 576–1,024 rows; original, random, rcm,
   gp, degree and gray × rowwise, fixed, variable and hierarchical;
   integer values, every timed product equal to scipy's square of the
   reordered operand), written to the port's cache, then per scheme the
   geomean speedup over identity row-wise, the share of matrices above 1
   and the share whose preprocessing costs under 20 identity SpGEMMs;
   (b) ``fit_calibration()`` from that cache, its ``describe()``
   printed; (c) for each spec and ``original``/``rcm`` × ``pallas``,
   the prior's ``kernel_rel`` beside the planner's measured one
   (``Planner._measure`` against the identity baseline); (d) one cold
   request on caveman-16384 and one on kron-14 through
   ``SpGEMMServer.submit``, each planned as the prior ranks first and
   equal to scipy's product; (e) ``plan_pipeline_stages`` /
   ``pipeline_spmm_apply`` on two kron-14-pattern stages, 8
   microbatches of 64 rows, every sum below 2^24, planned cold and in
   measured mode, each equal to scipy's chained product, K4 launched
   once per stage planned ``pallas``;
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
3g. the LM zoo's attention families, after phase 3d's memory is
   released, one model at a time (each released before the next), fp32,
   random weights from seed 0, ``run_serving(cfg, batch=4,
   prompt_len=1024, gen=32)``: qwen3-14b (dense, GQA 40 : 8, qk-norm;
   published size, 59.1 GB), granite-moe-3b-a800m (moe, 40 experts
   padded to 48, top-8; published size), musicgen-large (audio, the
   ``embeddings`` frontend; published size) and qwen2-vl-72b (vlm,
   M-RoPE; published width, depth cut to 4 of 80 layers: 286 GB of fp32
   weights hold on no card). Each prefill must launch the
   flash-attention kernel once per layer (40 / 32 / 48 / 4), every
   greedy token must lie in the vocabulary, and the kernel prefill
   (profiled) must agree with the chunked one as in phase 3d; prints
   prefill and decode times, tok/s, a profiled decode step and the peak
   memory. On qwen3-14b also: the prefilled cache quantized to int8 and
   back (layer 0's decode attention within the reference's 2e-2 bound;
   a whole decode step's logit difference, greedy agreement and the
   byte counts printed) and ``ServingEngine`` (4 slots, ``max_len``
   256, 6 seeded prompts of 40–56 tokens, 16 new tokens each: every
   request finished, all tokens in the vocabulary, the shared ``pos``
   past ``max_len``);
3h. training, after phase 3g's memory is released — (a)
   ``run_training("zamba2-2.7b", smoke=False, steps=8, batch=4,
   seq=1024, microbatches=2)`` (the reference's preset), fp32 with
   remat: the flash-attention and SSD counts zeroed just before and read
   just after must be 0 (the training path runs the model's chunked
   attention and SSD scan, as the reference's does), every loss finite,
   the first within 1.5 of ln(vocab), the last below the first; prints
   each step's time, tokens/s, the step's dense-product FLOPs over the
   fp32 peak and the peak memory, then one more step on the trained
   weights, profiled (device busy time, no LM kernel event); (b) one
   train step on the card and on the CPU from the same weights and data
   at a smoke config of each family (dense, moe, ssm, hybrid, audio,
   vlm), within the tolerance each line prints; (c) at smoke size on the
   card: compressed training whose loss falls, a step on a NaN weight
   skipped with nothing touched, and a run resumed from its checkpoint
   whose losses match the uninterrupted run's; (d) ``pipeline_apply``
   in a world of one over NCCL (in this process, a ``FileStore`` in a
   temporary directory, then destroyed), equal to the stage — NCCL puts
   no two ranks on one card, so the multi-rank schedule is held against
   the JAX package on the CPU only;
3i. the sharded LM and the dry-run analysis tier, after phase 3h's
   memory is released — (b) three production-mesh dry-run cells
   (qwen3-14b × train_4k, zamba2-2.7b × decode_32k, granite-moe-3b-a800m
   × train_4k on the fake 256-rank (16, 16) mesh), one
   ``repro_torch.launch.dryrun`` process each, started first on the
   host: each must be ``ok``; each roofline row and wall time printed;
   (a) ``FlopCounterMode`` around one full-width zamba2-2.7b train step
   (phase 3h's: fp32, 4 × 1,024, 2 microbatches, nested remat) and one
   qwen3-14b prefill (4 × 1,024, the chunked attention) on the card,
   each equal to ``trace_cost`` of the same function on fake tensors
   (extrapolated from one and two layer periods); each also timed
   uncounted, beside ``analyze(chips=1)`` at the fp32 peak (measured /
   max(compute_s, memory_s)), and the train step beside
   ``hybrid_train_flops``' structural count of its dense products;
   (c) each family's smoke config through the DTensor train step and two
   decode steps on a 1 × 1 × 1 ``DeviceMesh`` over NCCL (a world of one,
   then destroyed), equal to the plain steps within phase 3h's bounds;
4. summary — one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line,
   and last ``{"ok": true, "device": {...}}``.

``--rehearse`` runs the same phases on the CPU at small sizes through the
plain versions (no launch counts, no timings; the LM and training
phases on the smoke configs, ``pipeline_apply`` over gloo) and exits 2
without the final line: a dry run of the control flow before a card is
used (``tests/test_torch_smoke.py`` runs it).
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


# the phase running now, named in the line a failed run prints last,
# and when it started
PHASE = "start"
PHASE_START = None


def phase(title: str) -> None:
    """Log how long the last phase took, then the next phase's header,
    remembered for a failure's last line."""
    global PHASE, PHASE_START
    now = time.perf_counter()
    if PHASE_START is not None:
        log(f"  {PHASE} took {now - PHASE_START:.1f} s")
    PHASE, PHASE_START = title.split(":")[0], now
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
            got = CompactedC(slabs=got, keys=pack.keys, nrows=h.nrows,
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
    from repro_torch.planner.executor import KernelSpGEMM, KernelSpMM
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
    # the chaos request: a kernel_launch fault on a kron-14 request of a
    # server with its own resilience policy, degraded to the fixed rung;
    # the next request plans around the quarantined (original, pallas)
    # plan: on the card the prior's next candidate for a sparse B is the
    # kernel tier under rcm (one dense-strip launch), on the CPU a gather
    # scheme
    card = device.type == "cuda"
    want_launch = {"dense": (1, 0, 0), "sparse": (1, 0, 0),
                   "spmm": (0, 1, 0), "padded": (0, 0, 1),
                   "chain": (2, 0, 0), "chaos": (0, 0, 0),
                   "replanned": (1, 0, 0) if card else (0, 0, 0)}
    want_routes = {"dense": None, "sparse": {"sparse_c": 1},
                   "spmm": {}, "padded": {"padded": 1},
                   "chain": {"sparse_c": 2}, "chaos": {},
                   "replanned": None if card else {}}
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
            ok = (((resp.reorder, resp.scheme) == ("rcm", "pallas") if card
                   else resp.scheme != "pallas")
                  and not resp.plan_cache_hit and not resp.degraded)
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
            "exec_cap_bytes": planner.exec_cache.bytes_cap,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}
    # the kept packs of the window and SpMM routes carry A's live columns
    # (built once per packed operand); the padded grid reads slabs
    kinds = {}
    for _, e in planner.exec_cache.items():
        if isinstance(e, KernelSpMM):
            kind, cols = "KernelSpMM", e.cols
        elif isinstance(e, KernelSpGEMM):
            kind, cols = f"KernelSpGEMM:{e.pack.route}", e.pack.cols
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
    # the window launches: 8 on the seeded plans, 1 on the re-plan after
    # the chaos request (rcm+pallas)
    if device.type == "cuda" and launches != {"cluster_spgemm_windows": 9,
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


# ---------------------------------------------------------------------------
# phase 3e: the async front-end, a burst of small distinct requests
# ---------------------------------------------------------------------------


def burst_members(rehearse: bool) -> list:
    """The burst's square members, interleaved by family (one of each
    family in every run of four): kron, caveman, powerlaw and 2-D mesh
    patterns of 256 rows, eight seeds each (64 rows, one seed each in the
    rehearsal). ``BatchPolicy``'s sub-threshold bar is 256 rows, and
    eight members fill its 2,048-row pack exactly."""
    from repro_torch.core import suite
    if rehearse:
        rows, seeds = 64, (0,)
        kron_scale, side = 6, 8
    else:
        rows, seeds = 256, range(8)
        kron_scale, side = 8, 16
    families = (lambda s: suite.gen_kron(kron_scale, 16, seed=s),
                lambda s: suite.gen_caveman(rows, 24, seed=s),
                lambda s: suite.gen_powerlaw(rows, 12, seed=s),
                lambda s: suite.gen_mesh2d(side, seed=s))
    return [gen(s) for s in seeds for gen in families]


def burst_pairs(members, rng, density: float = 0.03) -> list:
    """A·B pairs: each member as A times a seeded sparse B of the same
    rows and twice the columns, integer-valued."""
    from repro_torch.core.formats import HostCSR
    out = []
    for a in members:
        n = a.nrows
        dense = ((rng.random((n, 2 * n)) < density)
                 * rng.integers(1, 4, (n, 2 * n))).astype(np.float32)
        out.append((integer_valued(a, rng), HostCSR.from_dense(dense)))
    return out


def burst_phase(members, device, rng, smi):
    """The async front-end on the card: ``AsyncSpGEMMServer`` serving a
    burst of small distinct requests, batched into block-diagonal
    launches of the window kernel, then unbatched, as A·B pairs, under a
    fault on the batched launch, through four worker threads, and with
    no seeded plans. Every launch counter is zeroed just before each run
    and read just after; every ticket must equal scipy's product."""
    import torch
    from repro_torch.core.formats import HostCSR, block_diag_csr
    from repro_torch.kernels.cluster_spgemm import cluster_spgemm_windows
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import get_tracer
    from repro_torch.planner.features import fingerprint
    from repro_torch.planner.plan_cache import Plan, PlanCache
    from repro_torch.planner.service import Planner
    from repro_torch.resilience import ResiliencePolicy, faults
    from repro_torch.serve.batcher import BatchPolicy
    from repro_torch.serve.engine import SpGEMMServer
    from repro_torch.serve.frontend import AsyncSpGEMMServer

    reg = obs_metrics.get_registry()
    variants = ("resident", "streamed", "streamed_db", "sparse_c")
    group = min(BatchPolicy().max_members, len(members))
    nbatch = len(members) // group

    def routes():
        return {v: reg.counter("kernel_launches", variant=v).value
                for v in variants}

    def outcomes():
        return {o: reg.counter("serve_batches", outcome=o).value
                for o in ("served", "disbanded")}

    def seeded_cache(a_list):
        """Pallas plans for each group's pack (``workload="batch"``, the
        pack's fingerprint in FIFO order) and each member's own A²."""
        cache = PlanCache()
        for g in range(0, len(a_list), group):
            pack = block_diag_csr(a_list[g:g + group])
            cache.put(Plan(fingerprint=fingerprint(pack.host),
                           reorder="original", scheme="pallas",
                           reuse_hint=20, workload="batch"))
        for a in a_list:
            cache.put(Plan(fingerprint=fingerprint(a), reorder="original",
                           scheme="pallas", reuse_hint=20))
        return cache

    def front_end(cache, policy=None, **kw):
        planner = Planner(cache=cache, device=device,
                          resilience=policy or ResiliencePolicy())
        return AsyncSpGEMMServer(SpGEMMServer(planner, default_reuse_hint=20),
                                 capacity=128, **kw)

    def serve(fe, reqs, *, profile=False, trace=False, fault=None,
              pump=True):
        """Submit ``reqs`` ((a, b) pairs) and drain them (``pump``: on
        this thread; else the front-end's workers do); the responses, the
        wall time, the launch, route and batch-outcome deltas, the profile
        and the spans."""
        tracer = get_tracer()
        if trace:
            tracer.clear()
            tracer.enable()
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and device.type == "cuda"
            else contextlib.nullcontext())
        r0, o0 = routes(), outcomes()
        cluster_spgemm_windows.launches = 0
        with ctx as prof, (fault or contextlib.nullcontext()):
            t0 = time.perf_counter()
            tickets = [fe.submit(a, b, reuse_hint=20) for a, b in reqs]
            if pump:
                fe.pump()
            resps = [t.result(600) for t in tickets]
            wall = time.perf_counter() - t0
        launches = cluster_spgemm_windows.launches
        spans = list(tracer.spans()) if trace else []
        tracer.disable()
        tracer.clear()
        d_route = {k: v - r0[k] for k, v in routes().items() if v - r0[k]}
        d_out = {k: v - o0[k] for k, v in outcomes().items()}
        return resps, wall, launches, d_route, d_out, prof, spans

    def check(label, reqs, resps):
        exact = [same_result(r, scipy_result(a, b, None), None)
                 for (a, b), r in zip(reqs, resps)]
        if not all(exact):
            raise SystemExit(f"burst {label}: tickets "
                             f"{[i for i, e in enumerate(exact) if not e]} "
                             "differ from scipy")

    def row(label, resps, wall, launches, d_route, d_out, fe, prof=None,
            **extra):
        busy, top = device_time(prof) if prof is not None else (None, None)
        kernel_ms = None
        if prof is not None:
            from torch.autograd import DeviceType
            kernel_ms = sum(ev.time_range.elapsed_us() / 1e3
                            for ev in prof.events()
                            if ev.device_type == DeviceType.CUDA
                            and "window_kernel" in ev.name)
        out = {"run": label, "gpu": smi, "requests": len(resps),
               "wall_s": wall,
               "sum_plan_s": sum(r.plan_s for r in resps),
               "sum_execute_s": sum(r.execute_s for r in resps),
               "window_launches": (launches if device.type == "cuda"
                                   else None),
               "routes": d_route, "serve_batches": d_out,
               "batched": sum(r.batched for r in resps),
               "batch_sizes": sorted({r.batch_size for r in resps}),
               "schemes": sorted({r.scheme for r in resps}),
               "degraded": sum(r.degraded for r in resps),
               "launch_amortization":
                   fe.stats()["batching"]["launch_amortization"],
               "device_busy_s": busy, "window_kernel_device_ms": kernel_ms,
               "device_top_ms": top, **extra}
        log("  burst", json.dumps(out))
        return out

    def fresh(mats):
        return [(integer_valued(a, rng), None) for a in mats]

    rows = []
    launches = {}
    on_card = device.type == "cuda"
    # (a) batched: the main path, unprofiled (wall time, spans), then a
    # profiled burst with fresh values (device time)
    fe = front_end(seeded_cache(members), workers=0,
                   batch_policy=BatchPolicy())
    reqs = fresh(members)
    resps, wall, n, d_route, d_out, _, spans = serve(fe, reqs, trace=True)
    check("a", reqs, resps)
    launches["batched"] = n
    # the batches' execute windows (the members' execute_s summed) hold
    # the launches, the syncs, the copies of the packs' dense C and the
    # float64 output guard; the guard is the windows less the execute
    # spans. The copy and the guard are also timed alone on a C of the
    # pack's shape
    span_s = {}
    for sp_ in spans:
        span_s[sp_.name] = span_s.get(sp_.name, 0.0) + sp_.duration
    c_shape = (group * members[0].nrows,) * 2
    c_host = np.zeros(c_shape, np.float32)
    c_dev = torch.zeros(c_shape, device=device)
    copy_ms = timed_ms(lambda: c_dev.cpu(), device)
    guard_ms = timed_ms(
        lambda: np.isfinite(np.sum(c_host, dtype=np.float64)), device)
    row_a = row("a: batched", resps, wall, n, d_route, d_out, fe,
                pack_c_shape=list(c_shape),
                pack_c_bytes=4 * c_shape[0] * c_shape[1],
                kept_fraction=1.0 / group,
                sum_batch_pack_s=span_s.get("batch_pack", 0.0),
                sum_operand_pack_s=span_s.get("pack", 0.0),
                sum_kernel_span_s=span_s.get("kernel", 0.0),
                sum_guard_s=(sum(r.execute_s for r in resps)
                             - span_s.get("execute", 0.0)),
                dense_c_copy_ms=copy_ms, float64_guard_ms=guard_ms)
    del c_host, c_dev
    ok = (d_out == {"served": nbatch, "disbanded": 0}
          and sum(d_route.values()) == nbatch
          and all(r.batched and r.batch_size == group for r in resps)
          and row_a["degraded"] == 0 and row_a["schemes"] == ["pallas"]
          and (n == nbatch or not on_card))
    rows.append(row_a)
    if not ok:
        raise SystemExit(f"burst a (batched) failed its checks: {row_a}")
    # the window kernel on the first batch's pack against its plain
    # version, on the route the served batches took
    pack = block_diag_csr([a for a, _ in reqs[:group]]).host
    pack_case, _, _ = window_case(
        f"window kernel, block-diagonal pack of {group} (burst)", pack,
        device, sparse_c="sparse_c" in d_route, timing=on_card)
    reqs = fresh(members)
    resps, wall, n, d_route, d_out, prof, _ = serve(
        fe, reqs, profile=True)
    check("a, profiled", reqs, resps)
    rows.append(row("a: batched, profiled", resps, wall, n, d_route, d_out,
                    fe, prof))
    if n != nbatch and on_card:
        raise SystemExit(f"burst a (profiled): {n} window launches")

    # (b) unbatched: one launch per request
    fe = front_end(seeded_cache(members), workers=0,
                   batch_policy=BatchPolicy(enabled=False))
    for label, profile in (("b: unbatched", False),
                           ("b: unbatched, profiled", True)):
        reqs = fresh(members)
        resps, wall, n, d_route, d_out, prof, _ = serve(fe, reqs,
                                                        profile=profile)
        check(label, reqs, resps)
        r = row(label, resps, wall, n, d_route, d_out, fe, prof)
        rows.append(r)
        if not (sum(d_route.values()) == len(members) and r["batched"] == 0
                and r["degraded"] == 0 and r["schemes"] == ["pallas"]
                and (n == len(members) or not on_card)):
            raise SystemExit(f"burst {label} failed its checks: {r}")
        launches.setdefault("unbatched", n)

    # (c) A·B pairs, one batch
    pairs = burst_pairs(members[:group], rng)
    cache = PlanCache()
    pack = block_diag_csr([a for a, _ in pairs])
    cache.put(Plan(fingerprint=fingerprint(pack.host), reorder="original",
                   scheme="pallas", reuse_hint=20, workload="batch"))
    fe = front_end(cache, workers=0, batch_policy=BatchPolicy())
    resps, wall, n, d_route, d_out, _, _ = serve(fe, pairs)
    check("c", pairs, resps)
    r = row("c: A·B pairs, batched", resps, wall, n, d_route, d_out, fe,
            b_shape=list(pairs[0][1].shape))
    rows.append(r)
    launches["pairs"] = n
    if not (d_out == {"served": 1, "disbanded": 0}
            and all(x.batched and x.batch_size == group for x in resps)
            and r["degraded"] == 0 and (n == 1 or not on_card)):
        raise SystemExit(f"burst c (A·B) failed its checks: {r}")

    # (d) chaos: a kernel_launch fault on the batched launch (two fires:
    # the batch, then the first member's own pallas run, which the ladder
    # recovers on the fixed rung); the batch disbands into singles
    policy = ResiliencePolicy()
    chaos_members = members[:group]
    fe = front_end(seeded_cache(chaos_members), policy, workers=0,
                   batch_policy=BatchPolicy())
    reqs = fresh(chaos_members)
    fault = faults.injected(faults.FaultPlan(
        0, sites=["kernel_launch"], rate=1.0, max_fires=2))
    resps, wall, n, d_route, d_out, _, _ = serve(fe, reqs, fault=fault)
    check("d", reqs, resps)
    fallbacks = [i.fallback for i in policy.incidents]
    r = row("d: chaos, faulted batch", resps, wall, n, d_route, d_out, fe,
            incidents=fallbacks, fallback_schemes=sorted(
                {x.fallback_scheme for x in resps} - {""}))
    rows.append(r)
    if not (d_out == {"served": 0, "disbanded": 1} and r["batched"] == 0
            and fallbacks == ["unbatch", "fixed"] and r["degraded"] == 1):
        raise SystemExit(f"burst d (chaos) failed its checks: {r}")

    # (e) four worker threads on the same members, fresh values: every
    # ticket resolves, equal to scipy (groups form as the workers drain,
    # so a pack may be unseeded and planned cold)
    fe = front_end(seeded_cache(members), workers=4,
                   batch_policy=BatchPolicy())
    try:
        reqs = fresh(members)
        resps, wall, n, d_route, d_out, _, _ = serve(fe, reqs, pump=False)
    finally:
        fe.close()
    check("e", reqs, resps)
    r = row("e: four worker threads", resps, wall, n, d_route, d_out, fe)
    rows.append(r)
    if len(resps) != len(members) or r["degraded"] != 0:
        raise SystemExit(f"burst e (threads) failed its checks: {r}")

    # (f) no seeded plans: the cold packs' scheme is printed, not asserted
    fe = front_end(PlanCache(), workers=0, batch_policy=BatchPolicy())
    reqs = fresh(members)
    resps, wall, n, d_route, d_out, _, _ = serve(fe, reqs)
    check("f", reqs, resps)
    rows.append(row("f: unseeded plans", resps, wall, n, d_route, d_out,
                    fe))

    # (g) non-integer values on the first batch's members, batched and
    # unbatched: a member's sums in the pack may run in another order
    # (the launch's unit groups follow the whole pack), so the two agree
    # within 1e-5 of the largest value; whether bit for bit is printed
    floats = [(HostCSR(a.indptr, a.indices, rng.uniform(
        0.5, 2.0, a.nnz).astype(np.float32), a.shape), None)
        for a in members[:group]]
    got, route = {}, {}
    for batching in (True, False):
        fe = front_end(seeded_cache([a for a, _ in floats]), workers=0,
                       batch_policy=BatchPolicy(enabled=batching))
        resps, wall, n, d_route, d_out, _, _ = serve(fe, floats)
        got[batching], route[batching] = resps, sorted(d_route)
        rows.append(row(f"g: float values, "
                        f"{'batched' if batching else 'unbatched'}", resps,
                        wall, n, d_route, d_out, fe))
    scale = max(float(np.abs(r.result).max()) for r in got[False])
    err = max(float(np.abs(b.result - u.result).max())
              for b, u in zip(got[True], got[False]))
    same = all(np.array_equal(b.result, u.result)
               for b, u in zip(got[True], got[False]))
    log("  float values", json.dumps({
        "gpu": smi, "members": len(floats), "routes": {
            "batched": route[True], "unbatched": route[False]},
        "max_abs_batched_vs_unbatched": err, "max_abs_value": scale,
        "tolerance": "<= 1e-5 x max|unbatched|", "bit_identical": same}))
    if not (err <= 1e-5 * scale and all(r.batched for r in got[True])):
        raise SystemExit(f"burst g: batched float values off by {err} "
                         f"(max value {scale})")
    log("  burst launches", json.dumps(launches))
    return launches, rows, pack_case


# ---------------------------------------------------------------------------
# phase 3f: the measurement tier and the card's prior
# ---------------------------------------------------------------------------

# the JAX quick tier's sweep: its matrices (representative_subset(8)),
# its reorderings beside the identity, and every clustering scheme
SWEEP_REORDERS = ("original", "random", "rcm", "gp", "degree", "gray")
SWEEP_SCHEMES = ("rowwise", "fixed", "variable", "hierarchical")
# the paper's preprocessing yardstick: inputs whose reordering and
# clustering cost less than 20 identity SpGEMMs
PRE_BUDGET_X = 20.0


def geomean(xs) -> float:
    return float(np.exp(np.log(np.asarray(xs, dtype=np.float64)).mean()))


def sweep_table(res, names, reorders, smi) -> list:
    """Per scheme and reordering (and per scheme over all of them): the
    geomean speedup over identity row-wise, the share of matrices above
    1, and the share whose preprocessing costs under ``PRE_BUDGET_X``
    identity SpGEMMs."""
    rows = []
    for scheme in SWEEP_SCHEMES:
        for algo in reorders + ("all",):
            algos = reorders if algo == "all" else (algo,)
            pairs = [(n, al) for n in names for al in algos
                     if (al, scheme) != ("original", "rowwise")]
            if not pairs:
                continue
            base = {n: res[(n, "original", "rowwise")].kernel_s
                    for n in names}
            speed = [base[n] / res[(n, al, scheme)].kernel_s
                     for n, al in pairs]
            pre = [res[(n, al, scheme)].preprocess_s / base[n]
                   for n, al in pairs]
            rows.append({
                "scheme": scheme, "reorder": algo, "n": len(pairs),
                "geomean_speedup": geomean(speed),
                "share_above_1": float(np.mean([s > 1.0 for s in speed])),
                "share_preprocess_under_20x": float(np.mean(
                    [p < PRE_BUDGET_X for p in pre])),
                "preprocess_median_x": float(np.median(pre)),
                "gpu": smi})
    return rows


def sweep_and_fit(mats, reorders, device, smi, *, rehearse):
    """Phase 3f (a) and (b): ``benchlib``'s sweep of ``mats`` on
    ``device`` — every timed product equal to scipy's square of the
    reordered operand — written to ``benchlib.CACHE_PATH``, its table
    printed, then ``fit_calibration()`` from that cache (a rehearsal
    fits its own device's rows)."""
    from repro_torch import benchlib
    from repro_torch.planner.calibration import (_load_cache_samples,
                                                 fit_calibration)

    names = list(mats)
    wrong = []

    def check(key):
        def run(b, c):
            want = (scipy_csr(b) @ scipy_csr(b)).toarray()
            got = c[: b.nrows, : b.ncols].cpu().numpy()
            if not np.array_equal(got, want.astype(np.float32)):
                wrong.append(key)
        return run

    res = {}
    t0 = time.perf_counter()
    for n in names:
        for algo in reorders:
            for scheme in SWEEP_SCHEMES:
                key = (n, algo, scheme)
                if scheme == "rowwise":
                    res[key] = benchlib.bench_rowwise_on(
                        mats[n], algo, name=n, device=device,
                        check=check(key))
                else:
                    res[key] = benchlib.bench_clusterwise_on(
                        mats[n], algo, scheme, name=n, device=device,
                        check=check(key))
    sweep_s = time.perf_counter() - t0
    if wrong or len(res) != len(names) * len(reorders) * len(SWEEP_SCHEMES):
        raise SystemExit(f"sweep products differ from scipy's: {wrong}")
    benchlib.save_cache()
    for n in names:
        base = res[(n, "original", "rowwise")]
        log("  sweep matrix", json.dumps({
            "spec": n, "identity_kernel_s": base.kernel_s,
            "flops": base.flops, "csr_bytes": base.mem_bytes,
            "speedup": {f"{al}+{sc}": base.kernel_s / res[(n, al, sc)].kernel_s
                        for al in reorders for sc in SWEEP_SCHEMES},
            "gpu": smi}))
    for row in sweep_table(res, names, reorders, smi):
        log("  sweep", json.dumps(row))
    log("  sweep run", json.dumps({
        "products": len(res), "all_equal_scipy": True, "wall_s": sweep_s,
        "cache": os.path.relpath(benchlib.CACHE_PATH, ROOT),
        "generation": benchlib.kernel_gen(device), "gpu": smi}))

    # (b) the fit, from that cache (the card's rows; a rehearsal reads
    # its own device's)
    if rehearse:
        cal = fit_calibration(samples=_load_cache_samples(
            benchlib.CACHE_PATH, benchlib.kernel_gen(device)))
    else:
        cal = fit_calibration()
    if cal is None:
        raise SystemExit("the sweep's cache gave the fit too few samples")
    log("  calibration", json.dumps({**cal.describe(), "gpu": smi}))


def measurement_phase(big, device, rng, smi, *, rehearse):
    """The measurement tier and the kernel tier's prior on the card:
    (a) benchlib's sweep on the binned gather passes, each timed product
    equal to the reordered operand's square by scipy (P·A²·Pᵀ, the
    identity product in the reordered order); (b) the calibration fitted
    from the sweep's cache; (c) the prior's ``kernel_rel`` for the kernel
    tier against the planner's own measurement; (d) one cold request on
    caveman and one on kron through ``SpGEMMServer.submit``; (e) the
    planner-driven pipeline of two kron-pattern stages, planned cold and
    in measured mode. Returns the kernels' launches of (c), (d) and (e)."""
    import tempfile

    from repro_torch import benchlib
    from repro_torch.core.suite import generate
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  pipeline_spmm_apply,
                                                  plan_pipeline_stages)
    from repro_torch.kernels.cluster_spgemm import (cluster_spgemm_padded,
                                                    cluster_spgemm_windows)
    from repro_torch.kernels.cluster_spmm import cluster_spmm_compact
    from repro_torch.obs.trace import get_tracer
    from repro_torch.planner.cost_model import IDENTITY, Candidate, CostModel
    from repro_torch.planner.features import extract_features
    from repro_torch.planner.plan_cache import PlanCache
    from repro_torch.planner.service import Planner
    from repro_torch.serve.engine import SpGEMMServer

    kernels = (cluster_spgemm_windows, cluster_spmm_compact,
               cluster_spgemm_padded)

    def zero():
        for k in kernels:
            k.launches = 0

    def counts():
        return {"window_launches": cluster_spgemm_windows.launches,
                "spmm_launches": cluster_spmm_compact.launches,
                "padded_launches": cluster_spgemm_padded.launches}

    launches = {"cluster_spgemm_windows": 0, "cluster_spmm_compact": 0,
                "cluster_spgemm_padded": 0}

    def bank(c):
        launches["cluster_spgemm_windows"] += c["window_launches"]
        launches["cluster_spmm_compact"] += c["spmm_launches"]
        launches["cluster_spgemm_padded"] += c["padded_launches"]

    # (a) the sweep, timed on the card, and (b) the fit from its cache (a
    # rehearsal's cache lives in a temporary directory, never the repo's)
    specs = benchlib.representative_subset(2 if rehearse else 8)
    reorders = SWEEP_REORDERS[:3] if rehearse else SWEEP_REORDERS
    names = [s.name for s in specs]
    mats = {s.name: integer_valued(generate(s), rng) for s in specs}
    log("  sweep matrices", json.dumps(
        {n: {"rows": h.nrows, "nnz": h.nnz} for n, h in mats.items()}))
    if rehearse:
        default = benchlib.CACHE_PATH
        with tempfile.TemporaryDirectory() as d:
            benchlib.CACHE_PATH = os.path.join(d, "bench_cache_torch.json")
            try:
                sweep_and_fit(mats, reorders, device, smi, rehearse=True)
            finally:
                benchlib.CACHE_PATH = default
    else:
        sweep_and_fit(mats, reorders, device, smi, rehearse=False)

    # (c) the prior against the kernel tier's measured kernel_rel
    prior = CostModel(device="cuda")
    planner = Planner(cache=PlanCache(), device=device)
    zero()
    errs = []
    for n in names:
        a = mats[n]
        f = extract_features(a)
        base = planner._measure(a, IDENTITY)
        for reorder in ("original", "rcm"):
            cand = Candidate(reorder, "pallas")
            s = prior.score(f, cand, 20)
            m = planner._measure(a, cand)
            rel = m.kernel_s / base.kernel_s
            errs.append(s.kernel_rel / rel)
            log("  prior", json.dumps({
                "spec": n, "candidate": cand.key,
                "tile128_fill": f.tile128_fill,
                "prior_kernel_rel": s.kernel_rel,
                "measured_kernel_rel": rel,
                "prior_over_measured": s.kernel_rel / rel,
                "prior_preprocess_rel": s.preprocess_rel,
                "measured_preprocess_rel": m.preprocess_s / base.kernel_s,
                "identity_kernel_s": base.kernel_s,
                "kernel_s": m.kernel_s, "gpu": smi}))
    c = counts()
    bank(c)
    log("  prior summary", json.dumps({
        "cases": len(errs), "geomean_prior_over_measured": geomean(errs),
        "min": min(errs), "max": max(errs), **c, "gpu": smi}))
    if device.type == "cuda" and c["window_launches"] == 0:
        raise SystemExit("the kernel tier's measurements launched no "
                         "window kernel")

    # (d) one cold request on caveman and one on kron: the prior decides
    server = SpGEMMServer(device=device)
    model = server.planner.cost_model
    for name in ("cave", "kron"):
        h = integer_valued(big[name], rng)
        first = model.choose(extract_features(h), server.default_reuse_hint)
        zero()
        resp = server.submit(h)
        c = counts()
        bank(c)
        exact = bool(np.array_equal(
            resp.result, scipy_result(h, None, None).astype(np.float32)))
        row = {"matrix": name, "scheme": resp.scheme,
               "reorder": resp.reorder, "prior_first": first.candidate.key,
               "prior_kernel_rel": first.kernel_rel,
               "plan_cache_hit": resp.plan_cache_hit,
               "degraded": resp.degraded, "plan_s": resp.plan_s,
               "execute_s": resp.execute_s, **c, "exact": exact,
               "gpu": smi}
        log("  cold request", json.dumps(row))
        kernel = resp.scheme == "pallas"
        routed = (c["window_launches"] + c["padded_launches"] >= 1
                  if kernel else sum(c.values()) == 0)
        if not (exact and not resp.degraded and not resp.plan_cache_hit
                and f"{resp.reorder}+{resp.scheme}" == first.candidate.key
                and (routed or device.type == "cpu")):
            raise SystemExit(f"cold request on {name} failed its checks: "
                             f"{row}")
    del server

    # (e) the pipeline: two stages of kron's pattern, integer values so
    # small that every sum stays below 2^24 (exact in fp32)
    stages = [integer_valued(big["kron"], rng) for _ in range(2)]
    micro, rows_per = (2, 8) if rehearse else (8, 64)
    feat = stages[0].ncols
    x = rng.integers(0, 3, (micro, rows_per, feat)).astype(np.float32)
    flat = x.reshape(micro * rows_per, feat).T.astype(np.float64)
    bound, want = np.abs(flat), flat
    for s_ in stages:
        bound = abs(scipy_csr(s_)) @ bound
        want = scipy_csr(s_) @ want
    if not bound.max() < 2 ** 24:
        raise SystemExit(f"pipeline sums reach {bound.max()} >= 2^24")
    want = want.T.reshape(micro, rows_per, feat).astype(np.float32)
    tracer = get_tracer()
    for mode in ("cold", "measured"):
        planner = Planner(cache=PlanCache(), device=device)
        t0 = time.perf_counter()
        plans = plan_pipeline_stages(stages, micro, planner=planner,
                                     measure=mode == "measured")
        plan_s = time.perf_counter() - t0
        tracer.clear()
        tracer.enable()
        zero()
        t0 = time.perf_counter()
        try:
            y = pipeline_spmm_apply(plans, stages, x, planner=planner)
        finally:
            tracer.disable()
        apply_s = time.perf_counter() - t0
        c = counts()
        bank(c)
        stage_s = [sp_.duration for sp_ in tracer.spans()
                   if sp_.name == "stage"
                   and sp_.attrs.get("phase") == "execute"]
        tracer.clear()
        exact = bool(np.array_equal(y, want))
        row = {"mode": mode, "stages": [
            {"stage": i, "reorder": p.reorder, "scheme": p.scheme,
             "reuse_hint": p.reuse_hint, "execute_s": t}
            for i, (p, t) in enumerate(zip(plans, stage_s))],
            "microbatches": micro, "rows_per_microbatch": rows_per,
            "features": feat, "dense_width": micro * rows_per,
            "bubble_fraction": bubble_fraction(len(stages), micro),
            "max_sum": float(bound.max()), "plan_s": plan_s,
            "apply_s": apply_s, **c, "exact": exact, "gpu": smi}
        log("  pipeline", json.dumps(row))
        kernel_stages = sum(p.scheme == "pallas" for p in plans)
        if not (exact and len(stage_s) == len(stages)
                and (c["spmm_launches"] == kernel_stages
                     or device.type == "cpu")):
            raise SystemExit(f"pipeline ({mode}) failed its checks: {row}")
    log("  measurement-tier launches", json.dumps(launches))
    return launches


LOGIT_TOL = 2e-3
# the kernels of the LM prefill, by the name of their device launches
LM_KERNEL_TAGS = (("flash_attention", "flash_kernel"),
                  ("ssd_chunk_scan", "ssd_chunk_"))


def lm_kernel_counts() -> dict:
    """The LM kernels' launch counts."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    return {"flash_attention": flash_attention.launches,
            "ssd_chunk_scan": ssd_chunk_scan.launches}


def zero_lm_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    flash_attention.launches = 0
    ssd_chunk_scan.launches = 0


def serving_inputs(cfg, batch, prompt_len, device, seed=0):
    """The prompts ``run_serving`` draws from ``seed`` (tokens, or
    embeddings with M-RoPE's positions3), and the generator it goes on
    drawing each decode step's embeddings from."""
    import torch
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, prompt_len))).to(device)}, rng
    inputs = {"embeddings": torch.from_numpy(rng.standard_normal(
        (batch, prompt_len, cfg.d_model)).astype(np.float32)).to(device)}
    if cfg.m_rope:
        inputs["positions3"] = torch.arange(
            prompt_len, device=device)[None, None].expand(
                3, batch, prompt_len)
    return inputs, rng


def decode_inputs(cfg, nxt, rng, pos, device):
    """One decode step's batch after greedy tokens ``nxt`` (B, 1): the
    tokens, or a fresh embedding draw (with positions3 at ``pos``)."""
    import torch
    if cfg.frontend == "tokens":
        return {"tokens": nxt}
    bsz = nxt.shape[0]
    step = {"embeddings": torch.from_numpy(rng.standard_normal(
        (bsz, 1, cfg.d_model)).astype(np.float32)).to(device)}
    if cfg.m_rope:
        step["positions3"] = torch.full((3, bsz, 1), pos, device=device)
    return step


def prefill_check(cfg, params, batch_in, max_len, device):
    """The same weights and prompts prefilled through the model's own
    chunked path, then through the kernels (profiled: device time of each
    LM kernel); the logits over the real vocabulary must agree within
    ``LOGIT_TOL`` of the largest, all finite. Returns (the check's row,
    the kernel prefill's cache, its greedy next tokens (B, 1))."""
    import torch
    from repro_torch.models.transformer import prefill
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    v = cfg.vocab_size
    t0 = time.perf_counter()
    chunked, _ = prefill(cfg, params, batch_in, max_len, use_pallas=False)
    sync()
    chunked_s = time.perf_counter() - t0
    profile = device.type == "cuda"
    ctx = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
        if profile else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        kern, cache = prefill(cfg, params, batch_in, max_len,
                              use_pallas=True)
        sync()
        kern_s = time.perf_counter() - t0
    kern, chunked = kern[..., :v], chunked[..., :v]
    nxt = kern[:, -1].argmax(-1)[:, None]
    finite = bool(torch.isfinite(kern).all() and torch.isfinite(chunked).all())
    err = float((kern - chunked).abs().max())
    scale = float(chunked.abs().max())
    same_argmax = float((kern.argmax(-1) == chunked.argmax(-1)).float().mean())
    del kern, chunked
    per_kernel = None
    busy = None
    if profile:
        busy, _ = device_time(prof)
        per_kernel = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                for key, tag in LM_KERNEL_TAGS:
                    if tag in ev.name:
                        ms, cnt = per_kernel.get(key, (0.0, 0))
                        per_kernel[key] = (
                            ms + ev.time_range.elapsed_us() / 1e3, cnt + 1)
        per_kernel = {k: {"device_ms": v[0], "launches": v[1]}
                      for k, v in per_kernel.items()}
    check = {"kernel_prefill_s": kern_s, "chunked_prefill_s": chunked_s,
             "prefill_device_busy_s": busy,
             "kernel_device_time": per_kernel,
             "max_abs_logit_diff": err, "max_abs_logit": scale,
             "tolerance": (f"max|kernel - chunked| <= {LOGIT_TOL:g} x "
                           "max|chunked| over the real vocabulary"),
             "argmax_agreement": same_argmax, "finite": finite}
    if not finite or not err <= LOGIT_TOL * scale:
        log("  kernel vs chunked prefill", json.dumps(check))
        raise SystemExit(f"kernel prefill disagrees with the chunked path: "
                         f"{check}")
    return check, cache, nxt


def profiled_step(cfg, params, cache, step_in, device) -> dict:
    """One decode step after a warm-up one, profiled: how much of a step
    the card is busy."""
    import torch
    from repro_torch.serve.engine import make_serve_step
    profile = device.type == "cuda"
    step = make_serve_step(cfg)
    step(params, cache, step_in)           # warm-up
    with (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
          if profile else contextlib.nullcontext()) as dprof:
        t0 = time.perf_counter()
        step(params, cache, step_in)
        if profile:
            torch.cuda.synchronize(device)
        step_s = time.perf_counter() - t0
    step_busy, step_top = device_time(dprof) if profile else (None, None)
    step_events = (sum(1 for ev in dprof.events() if ev.device_type
                       == torch.autograd.DeviceType.CUDA)
                   if profile else None)
    return {"decode_step_s": step_s, "decode_step_device_busy_s": step_busy,
            "decode_step_device_events": step_events,
            "decode_step_device_top_ms": step_top}


def serve_and_count(cfg, device, batch, prompt_len, gen, seed):
    """The main path: ``run_serving`` with every LM kernel's count zeroed
    just before and read just after; greedy tokens checked against the
    vocabulary. Returns (launches, the serving row)."""
    import torch
    from repro_torch.launch.serve import run_serving
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    zero_lm_kernel_counts()
    t0 = time.perf_counter()
    out = run_serving(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                      seed=seed, device=device, use_pallas=True)
    wall = time.perf_counter() - t0
    launches = lm_kernel_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    toks = out["tokens"]
    in_vocab = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    expected = {"flash_attention": cfg.num_attn_layers,
                "ssd_chunk_scan": (cfg.num_layers if cfg.family in
                                   ("ssm", "hybrid") else 0)}
    row = {"arch": cfg.name, "family": cfg.family,
           "params": cfg.param_count(), "batch": batch,
           "prompt_len": prompt_len, "gen": gen,
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "decode_tok_per_s": out["decode_tok_per_s"],
           "prefill_tok_per_s": batch * prompt_len / out["prefill_s"],
           "run_serving_wall_s": wall, "launches_per_prefill": launches,
           "expected_launches": expected,
           "tokens_shape": list(toks.shape), "tokens_in_vocab": in_vocab,
           "sample_tokens": toks[0][:8].tolist(),
           "peak_device_bytes": peak}
    if not in_vocab or toks.shape != (batch, gen):
        log("  serving", json.dumps(row))
        raise SystemExit(f"greedy tokens off the vocabulary: {row}")
    if device.type == "cuda" and launches != expected:
        log("  serving", json.dumps(row))
        raise SystemExit(f"launch counts off the LM prefill: {launches}")
    return launches, row


def lm_phase(device, *, rehearse):
    """zamba2-2.7b served through ``run_serving`` (its published size on
    the card; the smoke config in the rehearsal): the prefill's kernel
    launches counted, greedy tokens checked against the vocabulary; then
    the same weights and prompts prefilled through the kernels (profiled)
    and through the model's own chunked path, whose logits must agree."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.transformer import init_params
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
    # the main path's run: counters zeroed just before, read just after
    launches, row = serve_and_count(cfg, device, batch, prompt_len, gen,
                                    seed)
    row["arch"] = arch
    log("  serving", json.dumps(row))

    # the same weights and prompts (run_serving's seed), prefilled through
    # the kernels and through the model's own chunked path
    params = init_params(cfg, seed, device=device)
    batch_in, _ = serving_inputs(cfg, batch, prompt_len, device, seed)
    check, cache, nxt = prefill_check(cfg, params, batch_in,
                                      prompt_len + gen, device)
    # one decode step after the kernel prefill, profiled: how much of a
    # step the card is busy
    check.update(profiled_step(cfg, params, cache, {"tokens": nxt}, device))
    del cache
    log("  kernel vs chunked prefill", json.dumps(check))
    return launches, row, check


# ---------------------------------------------------------------------------
# phase 3g: the LM zoo's attention families
# ---------------------------------------------------------------------------

# (arch, layers kept on the card: None for the published depth); the
# rehearsal runs each smoke config
ZOO_MODELS = (("qwen3-14b", None), ("granite-moe-3b-a800m", None),
              ("musicgen-large", None), ("qwen2-vl-72b", 4))
ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_REQUESTS, ENGINE_NEW = 4, 256, 6, 16
KV_INT8_TOL = 2e-2


def release(device, what: str) -> None:
    """Collect the garbage and give the cached blocks back; print what the
    card still holds."""
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        log(f"  device memory held after {what}: "
            f"{torch.cuda.memory_allocated(device) / 1e9:.3f} GB")


def int8_kv_check(cfg, params, cache, nxt, device) -> dict:
    """The prefilled cache quantized to int8 and back to fp32: layer 0's
    decode attention output for the next token's query (over every
    prefilled position) must lie within the reference's bound of the
    output from the full cache; then one whole decode step from each
    cache, compared but not asserted."""
    import torch
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.layers import apply_rope, rmsnorm, rope_cos_sin
    from repro_torch.models.transformer import _qkv, decode_step
    from repro_torch.serve.quant import (dequantize_kv, quantize_kv,
                                         quantized_cache_bytes)
    pos = int(cache["pos"]) - 1
    deq = dequantize_kv(quantize_kv(cache), dtype=torch.float32)
    with torch.inference_mode():
        attn = params["layers"][0]["attn"]
        q, _, _ = _qkv(cfg, attn, rmsnorm(params["embed"][nxt], attn["ln"],
                                          cfg.norm_eps))
        cos, sin = rope_cos_sin(torch.full_like(nxt, pos + 1), cfg.head_dim,
                                cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        want = decode_attention(q, cache["k"][0], cache["v"][0], pos)
        got = decode_attention(q, deq["k"][0], deq["v"][0], pos)
        excess = float(((got - want).abs()
                        / (KV_INT8_TOL + KV_INT8_TOL * want.abs())).max())
    full_bytes = sum(cache[k].numel() * cache[k].element_size()
                     for k in ("k", "v"))
    bf16_bytes, int8_bytes = quantized_cache_bytes(cache)
    step_q, _ = decode_step(cfg, params, {"tokens": nxt}, deq)
    step_f, _ = decode_step(cfg, params, {"tokens": nxt}, cache)
    v = cfg.vocab_size
    step_q, step_f = step_q[..., :v], step_f[..., :v]
    row = {"layer0_attention_max_abs_diff": float((got - want).abs().max()),
           "layer0_attention_max_abs": float(want.abs().max()),
           "tolerance": (f"|int8 - full| <= {KV_INT8_TOL:g} + "
                         f"{KV_INT8_TOL:g} |full| per element (the "
                         "reference's test_kv_quant_attention_output_close)"),
           "largest_share_of_tolerance": excess,
           "decode_step_max_abs_logit_diff_rel": float(
               (step_q - step_f).abs().max() / step_f.abs().max()),
           "greedy_tokens_agree": bool(torch.equal(step_q.argmax(-1),
                                                   step_f.argmax(-1))),
           "cache_bytes_fp32": full_bytes,
           "quantized_cache_bytes": {"bf16": bf16_bytes,
                                     "int8_and_scales": int8_bytes}}
    del deq
    log("  int8 kv", json.dumps(row))
    if not excess <= 1.0:
        raise SystemExit(f"int8 KV cache: layer 0's attention output off "
                         f"the {KV_INT8_TOL:g} bound: {row}")
    return row


def engine_check(cfg, params, device, rng) -> dict:
    """``ServingEngine`` with ``ENGINE_SLOTS`` slots and ``max_len``
    ``ENGINE_MAX_LEN``: ``ENGINE_REQUESTS`` seeded prompts of 40–56 tokens
    (so the shared ``pos``, which advances for every replayed prompt token
    and every decode step, passes ``max_len``), ``ENGINE_NEW`` new tokens
    each."""
    import torch
    from repro_torch.serve.engine import Request, ServingEngine
    lens = rng.integers(40, 57, ENGINE_REQUESTS)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new_tokens=ENGINE_NEW) for n in lens]
    eng = ServingEngine(cfg, params, slots=ENGINE_SLOTS,
                        max_len=ENGINE_MAX_LEN)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run(steps=4 * ENGINE_NEW * ENGINE_REQUESTS)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    replay = int(lens.sum())
    pos = int(eng.cache["pos"])
    done = all(r.done and len(r.out) == ENGINE_NEW for r in reqs)
    in_vocab = all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    row = {"arch": cfg.name, "slots": ENGINE_SLOTS,
           "max_len": ENGINE_MAX_LEN, "requests": ENGINE_REQUESTS,
           "prompt_lens": lens.tolist(), "new_tokens": ENGINE_NEW,
           "wall_s": wall, "replay_steps": replay,
           "decode_steps": pos - replay, "final_pos": pos,
           "pos_past_max_len": pos > ENGINE_MAX_LEN,
           "generated_tok_per_s": ENGINE_REQUESTS * ENGINE_NEW / wall,
           "steps_per_s": pos / wall, "all_done": done,
           "tokens_in_vocab": in_vocab,
           "sample_tokens": reqs[0].out[:8]}
    del eng
    log("  engine", json.dumps(row))
    if not (done and in_vocab and pos > ENGINE_MAX_LEN):
        raise SystemExit(f"ServingEngine failed its checks: {row}")
    return row


def zoo_phase(device, *, rehearse):
    """The dense, moe, audio and vlm families served through
    ``run_serving`` one model at a time (each released before the next):
    K10's launches per prefill counted, greedy tokens in the vocabulary,
    the kernel prefill against the chunked path; on qwen3-14b also the
    int8 KV cache and ``ServingEngine``."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.transformer import init_params
    batch, prompt_len, gen = (2, 64, 8) if rehearse else (4, 1024, 32)
    seed = 0
    launches = {"flash_attention": 0}
    rows = []
    for arch, layers in ZOO_MODELS:
        cfg = smoke_config(arch) if rehearse else get_config(arch)
        reduced = None
        if layers is not None and layers < cfg.num_layers:
            reduced = f"num_layers {cfg.num_layers} -> {layers}"
            cfg = dataclasses.replace(cfg, num_layers=layers)
        log(f"  config {cfg.name} ({cfg.family}): {cfg.num_layers} layers"
            f"{' (' + reduced + ')' if reduced else ''}, d_model "
            f"{cfg.d_model}, {cfg.num_heads} : {cfg.num_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}"
            + (f", {cfg.num_experts} experts (padded to "
               f"{cfg.num_experts_padded}) top-{cfg.experts_per_token}"
               if cfg.family == "moe" else "")
            + f", vocab {cfg.vocab_size}, {cfg.frontend} frontend")
        # the main path's run: counters zeroed just before, read just after
        got, row = serve_and_count(cfg, device, batch, prompt_len, gen,
                                   seed)
        launches["flash_attention"] += got["flash_attention"]
        row["arch"] = arch
        row["reduced"] = reduced
        log("  zoo serving", json.dumps(row))
        release(device, f"{arch}'s run_serving")

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        params = init_params(cfg, seed, device=device)
        n_params = sum(p.numel() for p in params.parameters())
        batch_in, rng = serving_inputs(cfg, batch, prompt_len, device, seed)
        check, cache, nxt = prefill_check(cfg, params, batch_in,
                                          prompt_len + gen, device)
        check["arch"] = arch
        check["param_tensors"] = n_params
        check["param_bytes"] = sum(p.numel() * p.element_size()
                                   for p in params.parameters())
        if arch == "qwen3-14b":
            check["int8_kv"] = int8_kv_check(cfg, params, cache, nxt, device)
        check.update(profiled_step(
            cfg, params, cache,
            decode_inputs(cfg, nxt, rng, int(cache["pos"]), device), device))
        del cache, batch_in
        release(device, f"{arch}'s prefill check")
        if arch == "qwen3-14b":
            check["engine"] = engine_check(cfg, params, device,
                                           np.random.default_rng(seed + 1))
        check["peak_device_bytes"] = (
            torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
        log("  zoo kernel vs chunked prefill", json.dumps(check))
        rows.append((row, check))
        del params
        release(device, arch)
    return launches, rows


# ---------------------------------------------------------------------------
# phase 3h: the training path
# ---------------------------------------------------------------------------

# zamba2-2.7b's launch preset (2 microbatches); 4 × 1,024 tokens a step
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = (
    "zamba2-2.7b", 8, 4, 1024, 2)
# one smoke config of each family, for the card against the CPU
TRAIN_FAMILIES = (("dense", "qwen3-14b"), ("moe", "granite-moe-3b-a800m"),
                  ("ssm", "mamba2-370m"), ("hybrid", "zamba2-2.7b"),
                  ("audio", "musicgen-large"), ("vlm", "qwen2-vl-72b"))
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-4, 1e-6


def hybrid_train_flops(cfg, tokens: int) -> dict:
    """FLOPs of one train step's dense products on the hybrid family, by
    the model's structure: the forward pass once, the backward pass
    (twice the forward), and the port's nested remat — each Mamba2
    layer's forward run twice more (its group's and its own recompute),
    the shared block's once more. Beside it, ``6 N T + 2 N T`` from the
    parameter count (the shared block counted once, remat as one more
    forward)."""
    d, din = cfg.d_model, cfg.ssm_d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_num_heads
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ssm = 2 * (d * (2 * din + 2 * g * n + h) + din * d)
    shared = 2 * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d
                  + 3 * d * cfg.d_ff)
    head = 2 * d * cfg.padded_vocab
    groups = cfg.num_layers // cfg.hybrid_attn_every
    fwd = (cfg.num_layers * ssm + groups * shared + head) * tokens
    remat = (2 * cfg.num_layers * ssm + groups * shared) * tokens
    n_params = cfg.param_count()
    return {"structural": 3 * fwd + remat,
            "six_n_t_plus_remat": 8 * n_params * tokens}


def train_full_width(device, smi, *, rehearse) -> dict:
    """(a) ``run_training`` on zamba2-2.7b at its published size (the
    smoke config in the rehearsal), fp32, remat on: the LM kernels'
    counts zeroed just before and read just after (0: the training path
    runs the chunked attention and SSD scan); losses finite, the first
    near ln(vocab), the last below the first; then one more step on the
    trained weights, profiled."""
    import math

    import torch
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.train import run_training
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    cfg = smoke_config(TRAIN_ARCH) if rehearse else get_config(TRAIN_ARCH)
    seq = 64 if rehearse else TRAIN_SEQ
    tokens = TRAIN_BATCH * seq
    log(f"  config {cfg.name}: {cfg.param_count():,} parameters, fp32 "
        f"weights, gradients and AdamW moments "
        f"({4 * cfg.param_count() * 4 / 1e9:.2f} GB), batch "
        f"{TRAIN_BATCH} x {seq} in {TRAIN_MICRO} microbatches, "
        f"{TRAIN_STEPS} steps")
    zero_lm_kernel_counts()
    t0 = time.perf_counter()
    out = run_training(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=seq,
                       microbatches=TRAIN_MICRO, log_every=1, device=device)
    wall = time.perf_counter() - t0
    launches = lm_kernel_counts()
    losses = out["losses"]
    # the first step also pays the allocator's first growth
    step_s = statistics.median(out["step_s"][1:])
    flops = hybrid_train_flops(cfg, tokens)
    row = {"arch": TRAIN_ARCH, "params": cfg.param_count(),
           "batch": TRAIN_BATCH, "seq": seq, "microbatches": TRAIN_MICRO,
           "steps": TRAIN_STEPS, "losses": losses, "step_s": out["step_s"],
           "median_step_s": step_s, "tokens_per_s": tokens / step_s,
           "train_flops": flops,
           "fp32_peak_share": (flops["structural"] / step_s
                               / PEAK_FP32_FLOPS),
           "fp32_peak_share_6nt": (flops["six_n_t_plus_remat"] / step_s
                                   / PEAK_FP32_FLOPS),
           "peak_device_bytes": out["peak_device_bytes"],
           "run_training_wall_s": wall, "lm_kernel_launches": launches,
           "gpu": smi}
    first_ok = abs(losses[0] - math.log(cfg.vocab_size)) < 1.5
    ok = (all(math.isfinite(x) for x in losses) and first_ok
          and losses[-1] < losses[0]
          and launches == {"flash_attention": 0, "ssd_chunk_scan": 0})
    if not ok:
        log("  train", json.dumps(row))
        raise SystemExit(f"training failed its checks: {row}")

    # one more step on the trained weights, profiled (fresh moments: the
    # run's state is not returned)
    params = out.pop("params")
    del out
    gc.collect()
    ocfg = AdamWConfig(lr_peak=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, TrainConfig(microbatches=TRAIN_MICRO,
                                            optimizer=ocfg))
    opt = init_opt_state(params, ocfg, device=device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=TRAIN_BATCH, frontend=cfg.frontend,
                      d_model=cfg.d_model, m_rope=cfg.m_rope)
    batch = make_batch(dcfg, TRAIN_STEPS, device=device)
    profile = device.type == "cuda"
    zero_lm_kernel_counts()
    with (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
          if profile else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        _, opt, m = step(params, opt, batch)
        if profile:
            torch.cuda.synchronize(device)
        prof_s = time.perf_counter() - t0
    row["profiled_step"] = {"wall_s": prof_s, "loss": float(m["loss"]),
                            "lm_kernel_launches": lm_kernel_counts()}
    if profile:
        busy, top = device_time(prof)
        names = [ev.name for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA]
        row["profiled_step"].update(
            device_busy_s=busy, device_events=len(names),
            device_top_ms=top,
            lm_kernel_events=sum(1 for n in names for _, tag in
                                 LM_KERNEL_TAGS if tag in n))
        if row["profiled_step"]["lm_kernel_events"]:
            raise SystemExit(f"a train step ran an LM kernel: {row}")
    del params, opt, batch
    log("  train", json.dumps(row))
    return row


def same_train_step(device, *, rehearse) -> list:
    """(b) One train step (2 microbatches, fresh moments) on the card and
    on the CPU from the same weights and data, at each family's smoke
    config: loss, grad norm, parameters and moments must agree."""
    import copy

    import torch
    from repro_torch.configs.base import smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    cpu = torch.device("cpu")
    rows = []
    for family, arch in TRAIN_FAMILIES:
        cfg = smoke_config(arch)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=4, seed=1, frontend=cfg.frontend,
                          d_model=cfg.d_model, m_rope=cfg.m_rope)
        step = make_train_step(cfg, TrainConfig(microbatches=2,
                                                optimizer=ocfg))
        start = init_params(cfg, 0, device=cpu)
        got = {}
        for dev in (device, cpu):
            params = copy.deepcopy(start).to(dev)
            opt = init_opt_state(params, ocfg, device=dev)
            params, opt, m = step(params, opt, make_batch(dcfg, 0,
                                                          device=dev))
            got[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                             float(m["lr"]),
                             {k: p.detach().cpu() for k, p in
                              params.named_parameters()},
                             {k: v.cpu() for k, v in opt.mu.items()})
        (l_d, n_d, lr, p_d, mu_d), (l_c, n_c, _, p_c, mu_c) = (
            got[device.type], got["cpu"])
        diffs = {k: (p_d[k] - p_c[k]).abs() for k in p_c}
        off = sum(int((e > TRAIN_PARAM_ATOL).sum()) for e in diffs.values())
        total = sum(e.numel() for e in diffs.values())
        mu_rel = max(float((mu_d[k] - mu_c[k]).abs().max())
                     / max(float(mu_c[k].abs().max()), 1e-30) for k in mu_c)
        row = {"family": family, "arch": cfg.name,
               "loss_card": l_d, "loss_cpu": l_c,
               "grad_norm_card": n_d, "grad_norm_cpu": n_c,
               "max_param_diff": max(float(e.max()) for e in diffs.values()),
               "params_beyond_atol": off, "param_elements": total,
               "max_moment_rel_diff": mu_rel,
               "tolerance": (f"loss {TRAIN_LOSS_RTOL:g} rel, grad norm and "
                             f"moments {TRAIN_NORM_RTOL:g} rel, parameters "
                             f"{TRAIN_PARAM_ATOL:g} abs on all but 1e-3 of "
                             f"the elements (gradients near Adam's eps), "
                             f"those within 2 lr")}
        ok = (abs(l_d - l_c) <= TRAIN_LOSS_RTOL * abs(l_c)
              and abs(n_d - n_c) <= TRAIN_NORM_RTOL * abs(n_c)
              and mu_rel <= TRAIN_NORM_RTOL
              and off <= 1e-3 * total
              and row["max_param_diff"] <= 2 * lr)
        log("  card vs cpu", json.dumps(row))
        if not ok:
            raise SystemExit(f"train step: card and CPU disagree: {row}")
        rows.append(row)
    return rows


def train_smoke_paths(device, tmp) -> dict:
    """(c) At smoke size on the card: compressed training, a non-finite
    step skipped, and a run resumed from its checkpoint against the
    uninterrupted run."""
    import math
    import shutil

    import torch
    from repro_torch.configs.base import smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.train import run_training
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    row = {}
    cmp = run_training("mamba2-370m", steps=25, batch=4, seq=64, lr=1e-3,
                       compress=True, log_every=1000, device=device)
    row["compressed"] = {"first_loss": cmp["first_loss"],
                         "final_loss": cmp["final_loss"]}
    cfg = smoke_config("qwen3-14b")
    params = init_params(cfg, 0, device=device)
    with torch.no_grad():
        params["final_norm"][0] = float("nan")
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    ocfg = AdamWConfig()
    opt = init_opt_state(params, ocfg, device=device)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2), 0, device=device)
    params, new_opt, m = make_train_step(cfg, TrainConfig(
        optimizer=ocfg))(params, opt, batch)
    untouched = all(torch.equal(p.detach().nan_to_num(),
                                before[k].nan_to_num())
                    for k, p in params.named_parameters())
    row["non_finite"] = {"skipped": m["skipped"],
                         "step": int(new_opt.step), "untouched": untouched}
    kw = dict(steps=20, batch=4, seq=32, ckpt_every=5, log_every=1000,
              device=device)
    whole = run_training("zamba2-2.7b", ckpt_dir=tmp, **kw)
    for s in (15, 20):
        shutil.rmtree(os.path.join(tmp, f"step_{s:09d}"))
    resumed = run_training("zamba2-2.7b", ckpt_dir=tmp, **kw)
    tail = whole["losses"][10:]
    row["resumed"] = {
        "losses_whole": tail, "losses_resumed": resumed["losses"],
        "bit_identical": resumed["losses"] == tail,
        "max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                            zip(resumed["losses"], tail)),
        "tolerance": f"{TRAIN_LOSS_RTOL:g} relative per loss (the card's "
                     "scatter-adds may sum in another order)"}
    log("  train paths", json.dumps(row))
    ok = (cmp["final_loss"] < cmp["first_loss"] - 0.1
          and all(math.isfinite(x) for x in cmp["losses"])
          and m["skipped"] == 1 and int(new_opt.step) == 0 and untouched
          and len(resumed["losses"]) == 10
          and row["resumed"]["max_rel_diff"] <= TRAIN_LOSS_RTOL)
    if not ok:
        raise SystemExit(f"training paths failed their checks: {row}")
    return row


def pipeline_one_rank(device, tmp) -> dict:
    """(d) ``pipeline_apply`` in a world of one (NCCL on the card, gloo in
    the rehearsal), in this process on a ``FileStore``, then destroyed:
    equal to the stage applied in order. NCCL puts no two ranks on one
    card, so the multi-rank schedule is held against the JAX package on
    the CPU only (``tests/test_torch_pipeline_apply.py``)."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.distributed.pipeline import pipeline_apply
    rng = np.random.default_rng(0)
    w1 = torch.from_numpy((rng.standard_normal((1, 16, 32)) * 0.3).astype(
        np.float32)).to(device)
    w2 = torch.from_numpy((rng.standard_normal((1, 32, 16)) * 0.3).astype(
        np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((6, 2, 16)).astype(
        np.float32)).to(device)

    def stage(p, a):
        return a + torch.tanh(a @ p["w1"]) @ p["w2"]

    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = pipeline_apply(stage, {"w1": w1, "w2": w2}, x)
    finally:
        dist.destroy_process_group()
    want = stage({"w1": w1[0], "w2": w2[0]}, x)
    row = {"backend": backend, "world": 1,
           "max_abs_err": float((got - want).abs().max())}
    log("  pipeline_apply", json.dumps(row))
    if not row["max_abs_err"] == 0.0:
        raise SystemExit(f"pipeline_apply (P = 1) is not the stage: {row}")
    return row


def train_phase(device, smi, *, rehearse) -> dict:
    """Phase 3h: (a) zamba2-2.7b trained at its published size, (b) the
    card against the CPU on every family, (c) compression, the non-finite
    skip and checkpoint/restart at smoke size, (d) ``pipeline_apply``
    with P = 1."""
    import tempfile

    import torch
    # the smoke models' CPU steps are thousands of tiny ops: one intra-op
    # thread each (under other busy processes, all-core threads spinning
    # on each op made a 4 s CPU run take 380 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = {"full_width": train_full_width(device, smi,
                                               rehearse=rehearse)}
        release(device, "the full-width training")
        rows["card_vs_cpu"] = same_train_step(device, rehearse=rehearse)
        with tempfile.TemporaryDirectory() as tmp:
            rows["paths"] = train_smoke_paths(device, tmp)
        with tempfile.TemporaryDirectory() as tmp:
            rows["pipeline"] = pipeline_one_rank(device, tmp)
    finally:
        torch.set_num_threads(threads)
    return rows


# ---------------------------------------------------------------------------
# phase 3i: the sharded LM and the dry-run analysis tier
# ---------------------------------------------------------------------------

# the production-mesh dry-run cells, each traced in its own process
ANALYSIS_CELLS = (("qwen3-14b", "train_4k"), ("zamba2-2.7b", "decode_32k"),
                  ("granite-moe-3b-a800m", "train_4k"))
COUNT_PREFILL_ARCH = "qwen3-14b"
DRYRUN_TIMEOUT_S = 600


def start_dry_runs(out_dir) -> list:
    """(b) One ``repro_torch.launch.dryrun`` process per production-mesh
    cell, started together (each on its own fake 256-rank world); they
    run on the host while (a) and (c) use the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape in ANALYSIS_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "single", "--out", out_dir]
        procs.append((arch, shape, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def finish_dry_runs(procs, out_dir, smi) -> list:
    """Wait for (b)'s processes and read their cells: every one ok."""
    rows = []
    for arch, shape, t0, proc in procs:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        path = os.path.join(out_dir, f"{arch}__{shape}__single.json")
        res = {}
        if os.path.exists(path):
            with open(path) as f:
                res = json.load(f)
        if proc.returncode != 0 or res.get("status") != "ok":
            raise SystemExit(
                f"dry-run cell {arch} x {shape} failed (rc "
                f"{proc.returncode}): {res.get('error')} "
                f"{(err or out)[-1500:]}")
        rf = res["roofline"]
        row = {"arch": arch, "shape": shape, "mesh": "single",
               "chips": rf["chips"], "wall_s": wall,
               "trace_s": res["lower_s"], "flops_total": rf["flops_total"],
               "bytes_total": rf["bytes_total"],
               "coll_wire_bytes_per_device":
                   rf["coll_wire_bytes_per_device"],
               "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
               "collective_s": rf["collective_s"],
               "bottleneck": rf["bottleneck"],
               "useful_ratio": rf["useful_ratio"],
               "peak_fraction": rf["peak_fraction"],
               "memory_stats": rf["memory_stats"],
               "collectives": {k: v["count"] for k, v in
                               rf["collectives"].items()},
               "hw": "NVIDIA H100 SXM5 datasheet limits", "host_gpu": smi}
        log("  dry-run", json.dumps(row))
        rows.append(row)
    return rows


def fake_period_flops(cfg, run, args_of) -> dict:
    """trace_cost of ``run(cut_cfg, params, *args)`` on fake tensors at
    one and two layer periods, extrapolated to ``cfg``'s depth (exact:
    ``tests/test_torch_roofline_tools.py``). ``args_of(cut_cfg)`` builds
    the other fake arguments."""
    import dataclasses

    import torch
    from repro_torch.launch.flop_cost import fake_mode, trace_cost
    from repro_torch.launch.specs import num_periods, period_layers
    from repro_torch.models.transformer import init_params
    counts = []
    for p in (1, 2):
        cut = dataclasses.replace(cfg, num_layers=p * period_layers(cfg))
        with fake_mode():
            params = init_params(cut, 0, device="cpu", dtype=torch.float32)
        counts.append(trace_cost(lambda *a, cut=cut: run(cut, *a), params,
                                 *args_of(cut)))
    full = num_periods(cfg)
    return {k: counts[0][k] + (full - 1) * (counts[1][k] - counts[0][k])
            for k in counts[0]}


def counted(fn, device):
    """(FlopCounterMode's count, seconds) of one run of ``fn``, whose
    result is dropped."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return fc.get_total_flops(), time.perf_counter() - t0


def count_check(device, smi, *, rehearse) -> list:
    """(a) FlopCounterMode's count of a full-width zamba2-2.7b train step
    (fp32, 4 × 1,024, 2 microbatches, nested remat) and of a qwen3-14b
    prefill (4 × 1,024, the chunked attention) on the card, each equal to
    ``trace_cost`` of the same function on fake tensors; each step timed
    again uncounted, beside ``analyze(chips=1)`` at the fp32 peak."""
    import torch
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, batch_spec, make_batch
    from repro_torch.launch.flop_cost import fake_mode
    from repro_torch.launch.roofline import HW, analyze
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import (AdamWConfig, OptState,
                                         init_opt_state)
    from repro_torch.train.step import TrainConfig, make_train_step
    seq = 64 if rehearse else TRAIN_SEQ
    ocfg = AdamWConfig(lr_peak=3e-4, warmup_steps=5, total_steps=10)
    tcfg = TrainConfig(microbatches=TRAIN_MICRO, skip_nonfinite=False,
                       optimizer=ocfg)
    no_colls = {"_total": {"count": 0, "bytes": 0, "wire_bytes": 0}}
    rows = []

    def finish(name, arch, cfg, shape, flops, step_s, fake, structural):
        rep = analyze(arch, shape, "one card", 1, {}, {}, no_colls, cfg,
                      fake, dtype=torch.float32)
        row = {"what": name, "arch": arch, "batch": shape.global_batch,
               "seq": shape.seq_len, "flop_counter_mode": flops,
               "trace_cost_fake": fake["flops"],
               "trace_cost_bytes": fake["bytes"], "equal": flops ==
               fake["flops"], "structural_dense_products": structural,
               "step_s": step_s, "compute_s": rep.compute_s,
               "memory_s": rep.memory_s, "bottleneck": rep.bottleneck,
               "measured_over_roofline":
                   step_s / max(rep.compute_s, rep.memory_s),
               "peak": f"fp32 {HW().peak_flops_fp32:g} FLOP/s, "
                       f"{HW().hbm_bw:g} B/s (H100 SXM5 datasheet)",
               "gpu": smi}
        log("  count", json.dumps(row))
        if not row["equal"]:
            raise SystemExit(f"FlopCounterMode on the card and trace_cost "
                             f"on fake tensors disagree: {row}")
        rows.append(row)

    # zamba2-2.7b: one train step
    cfg = smoke_config(TRAIN_ARCH) if rehearse else get_config(TRAIN_ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=TRAIN_BATCH, frontend=cfg.frontend,
                      d_model=cfg.d_model, m_rope=cfg.m_rope)
    step = make_train_step(cfg, tcfg)
    params = tfm.init_params(cfg, 0, device=device)
    opt = init_opt_state(params, ocfg, device=device)
    batch = make_batch(dcfg, 0, device=device)
    flops = counted(lambda: step(params, opt, batch), device)[0]
    t0 = time.perf_counter()
    step(params, opt, batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    del params, opt, batch
    release(device, "the counted train step")

    def train_args(cut):
        with fake_mode():
            fparams = tfm.init_params(cut, 0, device="cpu")
            fopt = init_opt_state(fparams, ocfg, device="cpu")
        # a real step counter: the schedule's scalars are host floats
        fopt = OptState(torch.zeros((), dtype=torch.int32), fopt.mu,
                        fopt.nu)
        return fopt, batch_spec(dcfg)

    def train_run(cut, fparams, fopt, fbatch):
        return make_train_step(cut, tcfg)(fparams, fopt, fbatch)

    fake = fake_period_flops(cfg, train_run, train_args)
    finish("train step", TRAIN_ARCH, cfg,
           ShapeSpec("train_4x1024", "train", seq, TRAIN_BATCH), flops,
           step_s, fake,
           hybrid_train_flops(cfg, TRAIN_BATCH * seq)["structural"])

    # qwen3-14b: one prefill through the chunked attention
    arch = COUNT_PREFILL_ARCH
    cfg = smoke_config(arch) if rehearse else get_config(arch)
    pcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=TRAIN_BATCH)
    params = tfm.init_params(cfg, 0, device=device)
    batch = {"tokens": make_batch(pcfg, 0, device=device)["tokens"]}
    flops = counted(
        lambda: tfm.prefill(cfg, params, batch, seq, use_pallas=False),
        device)[0]
    t0 = time.perf_counter()
    out = tfm.prefill(cfg, params, batch, seq, use_pallas=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    del params, batch, out
    release(device, "the counted prefill")

    def prefill_args(cut):
        return ({"tokens": batch_spec(pcfg)["tokens"]},)

    def prefill_run(cut, fparams, fbatch):
        return tfm.prefill(cut, fparams, fbatch, seq, use_pallas=False)

    fake = fake_period_flops(cfg, prefill_run, prefill_args)
    finish("prefill", arch, cfg,
           ShapeSpec("prefill_4x1024", "prefill", seq, TRAIN_BATCH), flops,
           step_s, fake, 2 * cfg.active_param_count() * TRAIN_BATCH * seq)
    return rows


def sharded_steps(device, tmp) -> list:
    """(c) Each family's smoke config through the DTensor train step and
    two decode steps on a 1 × 1 × 1 DeviceMesh (NCCL on the card, gloo in
    the rehearsal; a world of one in this process, then destroyed), held
    against the plain port's steps on the same device with phase 3h's
    bounds."""
    import copy
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import TrainConfig, make_train_step
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    rows = []
    try:
        mesh = init_device_mesh(device.type, (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        rules = shd.Rules(mesh=mesh, data_axes=("pod", "data"))
        ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
        for family, arch in TRAIN_FAMILIES:
            cfg = smoke_config(arch)
            dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=4, seed=1, frontend=cfg.frontend,
                              d_model=cfg.d_model, m_rope=cfg.m_rope)
            step = make_train_step(cfg, TrainConfig(microbatches=2,
                                                    optimizer=ocfg))
            batch = make_batch(dcfg, 0, device=device)
            start = tfm.init_params(cfg, 0, device=device)
            ref = copy.deepcopy(start)
            ref, _, m_ref = step(ref, init_opt_state(ref, ocfg,
                                                     device=device), batch)
            params = copy.deepcopy(start)
            opt = init_opt_state(params, ocfg, device=device)
            shd.shard_params(params, mesh, shd.param_specs(cfg, rules))
            opt = shd.shard_opt_state(opt, mesh, shd.param_specs(
                cfg, rules, fsdp=True))
            bsp = shd.batch_specs(cfg, rules, "train")
            sbatch = {k: shd.shard_tensor(v, mesh, bsp[k])
                      for k, v in batch.items()}
            with shd.use_rules(rules), implicit_replication():
                params, opt, m = step(params, opt, sbatch)
            loss = float(m["loss"].full_tensor())
            lr = float(m["lr"])
            want = dict(ref.named_parameters())
            diffs = [(p.detach().full_tensor() - want[k].detach()).abs()
                     for k, p in params.named_parameters()]
            off = sum(int((e > TRAIN_PARAM_ATOL).sum()) for e in diffs)
            total = sum(e.numel() for e in diffs)
            # two decode steps from the start weights
            if cfg.frontend == "tokens":
                sb = {"tokens": batch["tokens"][:, :1]}
            else:
                sb = {"embeddings": batch["embeddings"][:, :1]}
                if cfg.m_rope:
                    sb["positions3"] = batch["positions3"][:, :, :1]
            cache = tfm.init_cache(cfg, 4, 16, device=device)
            want_lg = []
            for _ in range(2):
                lg, cache = tfm.decode_step(cfg, start, sb, cache)
                want_lg.append(lg.clone())
            sharded = copy.deepcopy(start)
            shd.shard_params(sharded, mesh, shd.param_specs(cfg, rules))
            scache = shd.shard_cache(tfm.init_cache(cfg, 4, 16,
                                                    device=device),
                                     mesh, shd.cache_specs(cfg, rules))
            dsp = shd.batch_specs(cfg, rules, "decode")
            ssb = {k: shd.shard_tensor(v, mesh, dsp[k])
                   for k, v in sb.items()}
            logit_err = 0.0
            with shd.use_rules(rules), implicit_replication():
                for w in want_lg:
                    lg, scache = tfm.decode_step(cfg, sharded, ssb, scache)
                    logit_err = max(logit_err, float(
                        (lg.full_tensor() - w).abs().max()))
            row = {"family": family, "arch": cfg.name, "backend": backend,
                   "loss_sharded": loss, "loss_plain": float(m_ref["loss"]),
                   "max_param_diff": max(float(e.max()) for e in diffs),
                   "params_beyond_atol": off, "param_elements": total,
                   "decode_max_abs_err": logit_err,
                   "tolerance": (f"loss {TRAIN_LOSS_RTOL:g} rel, parameters "
                                 f"{TRAIN_PARAM_ATOL:g} abs on all but 1e-3 "
                                 f"of the elements, those within 2 lr; "
                                 f"decode logits 1e-5 abs")}
            log("  sharded vs plain", json.dumps(row))
            ok = (abs(loss - row["loss_plain"])
                  <= TRAIN_LOSS_RTOL * abs(row["loss_plain"])
                  and off <= 1e-3 * total
                  and row["max_param_diff"] <= 2 * lr
                  and logit_err <= 1e-5)
            if not ok:
                raise SystemExit(f"the DTensor steps disagree with the "
                                 f"plain ones: {row}")
            rows.append(row)
    finally:
        dist.destroy_process_group()
    return rows


def rehearse_dry_run(out_dir) -> list:
    """(b) in the rehearsal: one smoke-sized cell of each kind on a fake
    (2, 2) mesh in this process (the production mesh's cells take
    minutes of host time)."""
    import torch.distributed as dist
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import ensure_fake_world, make_test_mesh
    ensure_fake_world(4)
    rows = []
    try:
        mesh = make_test_mesh(data=2, model=2)
        for arch, kind in (("qwen3-14b", "train"), ("zamba2-2.7b", "decode"),
                           ("granite-moe-3b-a800m", "train")):
            shape = ShapeSpec(f"smoke_{kind}", kind, 32, 4)
            t0 = time.perf_counter()
            r = run_cell(arch, shape.name, False, out_dir=out_dir,
                         verbose=False, mesh=mesh, cfg=smoke_config(arch),
                         shape=shape)
            if r["status"] != "ok":
                raise SystemExit(f"dry-run cell failed: {r.get('error')}")
            row = {"arch": arch, "shape": shape.name,
                   "wall_s": time.perf_counter() - t0,
                   "bottleneck": r["roofline"]["bottleneck"]}
            log("  dry-run", json.dumps(row))
            rows.append(row)
    finally:
        dist.destroy_process_group()
    return rows


def analysis_phase(device, smi, *, rehearse) -> dict:
    """Phase 3i: (b) started first on the host, then (a) and (c) on the
    card, then (b) joined."""
    import tempfile

    import torch
    out_dir = os.path.join(ROOT, "experiments", "dryrun_torch")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = [] if rehearse else start_dry_runs(out_dir)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rows = {}
    try:
        rows["counts"] = count_check(device, smi, rehearse=rehearse)
        with tempfile.TemporaryDirectory() as tmp:
            rows["sharded"] = sharded_steps(device, tmp)
        rows["dry_run"] = (rehearse_dry_run(out_dir) if rehearse
                           else finish_dry_runs(procs, out_dir, smi))
    finally:
        torch.set_num_threads(threads)
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    rows["phase_s"] = time.perf_counter() - t0
    return rows


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
                        (4, 128, 80, "bfloat16"), (4, 128, 80, "float16"),
                        (10, 64, 128, "float32"), (6, 64, 64, "float32")]
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
        # D = 160 (the 32-key-block instantiation), the prefill's shape
        # in bf16 and fp16, and phase 3g's prefills: qwen3-14b's (4 × 40
        # query heads of 128) and granite-moe-3b's (4 × 24 of 64)
        flash_shapes = [(128, 1024, 80, "float32"), (128, 1000, 80, "float32"),
                        (64, 1024, 128, "float32"), (32, 1024, 160, "float32"),
                        (128, 1024, 80, "bfloat16"),
                        (128, 1024, 80, "float16"),
                        (160, 1024, 128, "float32"),
                        (96, 1024, 64, "float32")]
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
    members = burst_members(args.rehearse)
    log(f"  matrices: kron {kron.shape} nnz {kron.nnz}, caveman "
        f"{cave.shape} nnz {cave.nnz}, powerlaw {plaw.shape} nnz "
        f"{plaw.nnz}, wide A {wide_a.shape} nnz {wide_a.nnz} x mesh "
        f"{wide_b.shape} nnz {wide_b.nnz}, burst: {len(members)} members "
        f"of {members[0].nrows} rows, nnz {sum(m.nnz for m in members)} "
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
    phase("phase 3e: async front-end, a burst of small distinct requests "
          "(AsyncSpGEMMServer, block-diagonal batches)")
    burst_launches, _, burst_pack = burst_phase(members, device, rng, smi)
    # the batch path's launches of the window kernel join the main path's
    launches["cluster_spgemm_windows"] += (burst_launches["batched"]
                                           + burst_launches["pairs"])
    phase("phase 3f: the measurement tier and the card's prior (benchlib "
          "sweep, calibration, prior against the kernel tier, cold "
          "requests, the planner-driven pipeline)")
    prior_launches = measurement_phase(
        {"kron": kron, "cave": cave}, device, rng, smi,
        rehearse=args.rehearse)
    # its launches of the kernels join the main path's
    for name, n in prior_launches.items():
        launches[name] += n
    # the SpGEMM phases' device memory is released before the LM phases
    release(device, "the SpGEMM phases")
    phase("phase 3d: LM serving, run_serving('zamba2-2.7b')")
    lm_launches, _, _ = lm_phase(device, rehearse=args.rehearse)
    launches.update(lm_launches)
    release(device, "phase 3d")
    phase("phase 3g: LM zoo serving (qwen3-14b, granite-moe-3b-a800m, "
          "musicgen-large, qwen2-vl-72b cut to 4 layers), ServingEngine, "
          "int8 KV cache")
    zoo_launches, _ = zoo_phase(device, rehearse=args.rehearse)
    launches["flash_attention"] += zoo_launches["flash_attention"]
    release(device, "phase 3g")
    phase("phase 3h: training (run_training on zamba2-2.7b at its "
          "published size, the card against the CPU per family, "
          "compression, the non-finite skip, checkpoint/restart, "
          "pipeline_apply with P = 1)")
    train_phase(device, smi, rehearse=args.rehearse)
    release(device, "phase 3h")
    phase("phase 3i: the sharded LM and the dry-run analysis tier "
          "(FlopCounterMode against trace_cost, production-mesh dry-run "
          "cells, DTensor steps on a 1 x 1 x 1 mesh)")
    analysis_phase(device, smi, rehearse=args.rehearse)

    # -- phase 4: summary ------------------------------------------------------
    phase("phase 4: summary")
    win_cases = [dense, slab, tall, bf16, burst_pack] + nonfinite[:2]
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

    windows_entry = entry(
        "cluster_spgemm_windows",
        "src/repro_torch/kernels/csrc/cluster_spgemm.cu",
        "src/repro/kernels/cluster_spgemm.py:336 (K1 "
        "cluster_spgemm_pairs; also :389 K2, :462 K3, :746 K5a, "
        ":816 K5b)", win_cases, dense)
    # phase 3e's launches: one per batch of the batched and A·B bursts
    # (in "launches" too), one per request unbatched
    windows_entry["batch_launches"] = burst_launches
    kernels = {"kernels": [
        windows_entry,
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
