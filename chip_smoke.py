#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root with one CUDA card visible::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. environment — the card's name and power limit, the CUDA version, and
   the build of both kernel sources with nvcc (one process per source,
   all started together, into ``build/repro_torch/``);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it: integer-valued operands compare
   exactly (``torch.equal``); each case prints its time (CUDA events,
   median of 5 after a warm-up), the plain version's, the bound (from the
   work the product needs: true flops, CSR operands read once, the result
   written once), the bound of the kernel's tile-padded work beside it,
   and one PyTorch library call timed as a yardstick the port never
   calls;
3. the serving path — ``SpGEMMServer.submit`` with pallas plans seeded in
   the plan cache (kron-14 A² on the dense-strip route and caveman-16384
   A² reordered by RCM on the sparse-C route, three fresh-valued requests
   and one repeat each; one kron-14 × dense-B SpMM): every launch counter
   is zeroed just before and read just after, and every result must
   equal scipy's product exactly; each request's ``execute_s`` is split
   by profiler device time and by tracing spans; then one unseeded
   request in measured mode, whose choice is printed, not asserted;
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
        windows, a_vals = pack.windows, pack.stream[2]
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


def serve_phase(mats, device, rng, spmm_cols):
    import torch
    from repro_torch.kernels.cluster_spgemm import cluster_spgemm_windows
    from repro_torch.kernels.cluster_spmm import cluster_spmm_compact
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import get_tracer
    from repro_torch.planner.cost_model import Candidate
    from repro_torch.planner.features import fingerprint
    from repro_torch.planner.plan_cache import Plan, PlanCache
    from repro_torch.planner.service import Planner, _materialize
    from repro_torch.serve.engine import SpGEMMServer

    kron, cave = mats["kron"], mats["cave"]
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(kron), reorder="original",
                   scheme="pallas", reuse_hint=20))
    perm, bounds, mc, _ = _materialize(cave, Candidate("rcm", "pallas"))
    cache.put(Plan(fingerprint=fingerprint(cave), reorder="rcm",
                   scheme="pallas", reuse_hint=20, max_cluster=mc,
                   perm=perm, boundaries=bounds))
    cache.put(Plan(fingerprint=fingerprint(kron), reorder="original",
                   scheme="pallas", reuse_hint=20, workload="spmm"))
    server = SpGEMMServer(Planner(cache=cache, device=device),
                          default_reuse_hint=20)
    reg = obs_metrics.get_registry()

    def route_counts():
        return {v: reg.counter("kernel_launches", variant=v).value
                for v in ("resident", "streamed", "streamed_db",
                          "sparse_c")}

    # three fresh-valued requests per matrix (plan-cache hits that pack
    # anew), then one repeat of the last values: the exec-cache hit of
    # steady serving, which goes straight to the kernel
    requests = ([("kron", "a2", "dense", False)] * 3
                + [("kron", "a2", "dense", True)]
                + [("cave", "a2", "sparse", False)] * 3
                + [("cave", "a2", "sparse", True)]
                + [("kron", "spmm", "spmm", False)])
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
    for i, (name, workload, route, repeat) in enumerate(requests):
        if not repeat:
            h = integer_valued(mats[name], rng)
        b = None
        if workload == "spmm":
            b = rng.integers(1, 4, (h.ncols, spmm_cols)).astype(np.float32)
        before = (cluster_spgemm_windows.launches,
                  cluster_spmm_compact.launches, route_counts())
        # every request on the card is profiled for its device time
        profile = device.type == "cuda"
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
        with ctx as prof:
            resp = server.submit(h, b)
        after = (cluster_spgemm_windows.launches,
                 cluster_spmm_compact.launches, route_counts())
        d_win = after[0] - before[0]
        d_spmm = after[1] - before[1]
        d_route = {k: after[2][k] - before[2][k] for k in after[2]}
        hs = scipy_csr(h)
        want = (hs @ hs).toarray() if b is None else hs @ b
        exact = bool(np.array_equal(resp.result, want.astype(np.float32)))
        if route == "dense":
            route_ok = d_route["sparse_c"] == 0 and sum(d_route.values()) == 1
        elif route == "sparse":
            route_ok = d_route["sparse_c"] == 1 and sum(d_route.values()) == 1
        else:
            route_ok = sum(d_route.values()) == 0
        want_launch = (0, 1) if workload == "spmm" else (1, 0)
        counted = (d_win, d_spmm) == want_launch or device.type == "cpu"
        busy, top = device_time(prof) if profile else (None, None)
        span_s = {}
        for sp_ in tracer.spans():
            if sp_.trace_id == resp.trace_id:
                span_s[sp_.name] = span_s.get(sp_.name, 0.0) + sp_.duration
        row = {"request": i, "matrix": name, "workload": workload,
               "repeat": repeat,
               "scheme": resp.scheme, "reorder": resp.reorder,
               "plan_cache_hit": resp.plan_cache_hit, "route": route,
               "route_ok": route_ok, "window_launches": d_win,
               "spmm_launches": d_spmm, "exact": exact,
               "plan_s": resp.plan_s, "execute_s": resp.execute_s,
               "device_busy_s": busy, "device_top_ms": top,
               "host_share_of_execute": (None if busy is None or busy <= 0
                                         else 1.0 - busy / resp.execute_s),
               "pack_s": span_s.get("pack", 0.0),
               "kernel_span_s": span_s.get("kernel", 0.0),
               "guard_s": resp.execute_s - span_s.get("execute", 0.0)}
        log("  request", json.dumps(row))
        if not (resp.scheme == "pallas" and resp.plan_cache_hit and exact
                and route_ok and counted):
            raise SystemExit(f"serving request {i} ({name}, {workload}) "
                             f"failed its checks: {row}")
    launches = {"cluster_spgemm_windows": cluster_spgemm_windows.launches,
                "cluster_spmm_compact": cluster_spmm_compact.launches}
    tracer.disable()
    tracer.clear()
    log("  main-path launches", json.dumps(launches))
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
                                              "cluster_spmm_compact": 1}:
        raise SystemExit(f"launch counts off the main path: {launches}")

    # one unseeded request in measured mode: the choice is printed only
    measured = SpGEMMServer(device=device, measure=True)
    t0 = time.perf_counter()
    resp = measured.submit(integer_valued(cave, rng))
    log("  measured-mode request", json.dumps({
        "matrix": "cave", "scheme": resp.scheme, "reorder": resp.reorder,
        "plan_s": resp.plan_s, "execute_s": resp.execute_s,
        "wall_s": time.perf_counter() - t0}))
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
        log(f"  kernel build: {build_s:.2f} s (both sources in parallel)")
        for name, text in build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"    {name}: {line.strip()}")

    # -- matrices (suite generators, seeded) -----------------------------------
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if args.rehearse:
        kron = suite.gen_kron(10, 16, seed=0)
        cave = suite.gen_caveman(4096, 24, seed=0)
        plaw = suite.gen_powerlaw(512, 12, seed=3)
        spmm_cols, ragged_cols = 16, 10
    else:
        kron = suite.gen_kron(14, 16, seed=0)
        cave = suite.gen_caveman(16384, 24, seed=0)
        plaw = suite.generate(next(s for s in suite.SUITE
                                   if s.name == "plaw_4096_12"))
        spmm_cols, ragged_cols = 64, 40
    mats = {"kron": kron, "cave": cave}
    log(f"  matrices: kron {kron.shape} nnz {kron.nnz}, caveman "
        f"{cave.shape} nnz {cave.nnz}, powerlaw {plaw.shape} nnz "
        f"{plaw.nnz} ({time.perf_counter() - t0:.1f} s)")

    # -- phase 2: kernels vs plain versions ------------------------------------
    log("phase 2: kernels against their plain versions")
    kron_i = integer_valued(kron, rng)
    timing = not args.rehearse          # CPU times say nothing of a card
    dense, kron_windows, _ = window_case("dense-output window (kron)",
                                         kron_i, device, sparse_c=False,
                                         timing=timing)
    slab, _, _ = window_case("slab-output window (caveman)",
                             integer_valued(cave, rng), device,
                             sparse_c=True, timing=timing)
    tall, _, _ = window_case("block_k=512 window (powerlaw)",
                             integer_valued(plaw, rng), device,
                             sparse_c=False, timing=timing)
    from repro_torch.core.formats import HostCSR
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

    # -- phase 3: the serving path ---------------------------------------------
    log("phase 3: SpGEMMServer.submit with seeded pallas plans")
    launches = serve_phase(mats, device, rng, spmm_cols)

    # -- phase 4: summary ------------------------------------------------------
    win_cases = [dense, slab, tall, bf16]
    spmm_cases = [spmm, ragged]

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
