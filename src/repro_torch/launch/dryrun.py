"""Multi-pod dry-run: trace every (arch × shape) cell on the production
mesh (16×16 = 256 devices and 2×16×16 = 512) and extract memory, FLOP/byte
and collective statistics — the counterpart of the JAX package's
``launch/dryrun.py``.

The reference lowers and compiles each cell with XLA for 512 forced host
devices. The port needs no devices: the mesh lives on PyTorch's ``fake``
process-group backend (one process standing for every rank), the
parameters, batch, moments and cache are fake DTensors (nothing is
allocated on any device), and the step runs once under
:mod:`repro_torch.launch.flop_cost`'s counting mode. Eager tracing unrolls
every layer, so each cell is traced cut to one and to two layer periods
and extrapolated linearly to its full depth, as the reference's
``scan × length`` counts (exact: every period is the same program).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
Results: experiments/dryrun_torch/<arch>__<shape>__<mesh>.json, with the
collective log beside it (``.collectives.json``) where the reference
writes the HLO.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.launch.comm_stats import collective_stats, scale_stats
from repro_torch.launch.flop_cost import trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analyze
from repro_torch.launch.specs import build_cell, num_periods

__all__ = ["run_cell", "main", "OUT_DIR"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

NOTES = ("alias_size_in_bytes and generated_code_size_in_bytes are 0: an "
         "eager program donates no buffers and compiles no code; "
         "temp_size_in_bytes is the peak of the bytes the traced ops' "
         "outputs hold on one device; 16-wide model-axis collectives "
         "cross the network between two 8-GPU NVLink domains")


def _local_bytes(tree) -> int:
    """Bytes one device holds of a tree's tensors (a DTensor's local
    shard)."""
    import torch
    from torch.utils._pytree import tree_flatten
    total = 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            total += _local_bytes(list(x.parameters()))
        elif hasattr(x, "_fields"):
            total += _local_bytes(tuple(x))
        elif isinstance(x, torch.Tensor):
            t = getattr(x, "_local_tensor", x)
            total += t.numel() * t.element_size()
    return total


def measure_cell(arch: str, shape_name: str, mesh, *, cfg=None,
                 shape=None, periods=(1, 2)) -> dict:
    """The cell traced at one and two periods (``periods``) and
    extrapolated linearly to full depth: {"cost", "collectives",
    "records" (the second trace's log), "memory_stats", "notes", "dtype",
    "cfg"}. ``cfg`` and ``shape`` stand in for the arch's config and the
    named shape."""
    cfg = cfg or get_config(arch)
    full = num_periods(cfg)
    runs = []
    for p in periods:
        cell = build_cell(arch, shape_name, mesh, periods=p, cfg=cfg,
                          shape=shape)
        args_b = _local_bytes(cell.args)
        out = {}

        def fn(*args, cell=cell, out=out):
            out["value"] = cell.fn(*args)

        t = trace(fn, *cell.args, memory=True)
        out_b = _local_bytes(out.pop("value"))
        runs.append((cell, t, args_b, out_b))
    (c1, t1, a1, o1), (c2, t2, a2, o2) = runs
    p1, p2 = periods

    def ext(a, b):
        return a + (full - p1) * (b - a) / (p2 - p1)

    cost = {k: ext(getattr(t1, k), getattr(t2, k))
            for k in ("flops", "bytes", "bytes_ub")}
    colls = scale_stats(collective_stats(t1.collectives),
                        collective_stats(t2.collectives),
                        (full - p1) / (p2 - p1) + 1)
    mem = {"argument_size_in_bytes": ext(a1, a2),
           "output_size_in_bytes": ext(o1, o2),
           "temp_size_in_bytes": ext(t1.peak_bytes, t2.peak_bytes),
           "alias_size_in_bytes": 0,
           "generated_code_size_in_bytes": 0}
    return {"cost": cost, "collectives": colls, "records": t2.collectives,
            "memory_stats": mem, "notes": c2.notes, "dtype": c2.dtype,
            "cfg": cfg}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = OUT_DIR, verbose: bool = True,
             mesh=None, cfg=None, shape=None) -> dict:
    """Trace one cell on the production mesh (or ``mesh``) and write its
    JSON; a failure is recorded as ``status: "error"`` with its
    traceback. ``cfg`` and ``shape`` stand in for the arch's config and
    the named shape."""
    mesh_name = "multi" if multi_pod else "single"
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if not ok:
        result.update(status="skipped", reason=why)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        if verbose:
            print(f"[skip] {arch} × {shape_name} × {mesh_name}: {why}")
        return result

    t0 = time.time()
    try:
        mesh = mesh or make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        m = measure_cell(arch, shape_name, mesh, cfg=cfg, shape=shape)
        t_trace = time.time() - t0
        with open(path[:-len(".json")] + ".collectives.json", "w") as f:
            json.dump(m["records"], f)
        notes = "; ".join(x for x in (m["notes"], NOTES) if x)
        report = analyze(arch, shape, mesh_name, chips, {},
                         m["memory_stats"], m["collectives"], m["cfg"],
                         m["cost"], notes=notes, dtype=m["dtype"])
        result.update(status="ok", lower_s=round(t_trace, 1),
                      compile_s=0.0, roofline=report.to_json())
        if verbose:
            ms = result["roofline"]
            temp = m["memory_stats"]["temp_size_in_bytes"]
            print(f"[ok]   {arch} × {shape_name} × {mesh_name} "
                  f"chips={chips} "
                  f"compute={ms['compute_s']:.3e}s "
                  f"memory={ms['memory_s']:.3e}s "
                  f"coll={ms['collective_s']:.3e}s "
                  f"bottleneck={ms['bottleneck']} "
                  f"peak_frac={ms['peak_fraction']:.2%} "
                  f"temp={temp / 2**30:.2f}GiB (trace {t_trace:.1f}s)")
    except Exception as e:  # record failures — they are bugs to fix
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc())
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {mesh_name}: "
                  f"{type(e).__name__}: {e}")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose result JSON already says ok/skipped")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "multi" if mp else "single"
            path = os.path.join(args.out,
                                f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[keep] {arch} × {shape} × {mesh_name}")
                    continue
            r = run_cell(arch, shape, mp, out_dir=args.out)
            failed += r["status"] == "error"
    if failed:
        raise SystemExit(f"{failed} cell(s) FAILED")


if __name__ == "__main__":
    main()
