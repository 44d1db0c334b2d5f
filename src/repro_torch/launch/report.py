"""Render the dry-run and roofline tables from the port's dry-run JSONs —
the counterpart of the JAX package's ``launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single|multi|all]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")

__all__ = ["load", "dryrun_table", "roofline_table", "main"]


def load(mesh: str | None = None, directory: str = DRYRUN_DIR) -> list[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(directory, "*__*__*.json"))):
        if p.endswith(".collectives.json"):
            continue
        with open(p) as f:
            r = json.load(f)
        if mesh and r.get("mesh") != mesh:
            continue
        rows.append(r)
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
             "long_500k": 3}
    rows.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))
    return rows


def fmt_bytes(n: float) -> str:
    return f"{n/2**30:.2f}"


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | status | per-dev temp GiB | "
           "per-dev args GiB | collectives (count) | notes |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"SKIP | — | — | — | {r['reason'][:60]}… |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"**FAIL** | — | — | — | {r.get('error','')[:60]} |")
            continue
        rf = r["roofline"]
        ms = rf["memory_stats"]
        colls = rf["collectives"]
        cstr = " ".join(f"{k.split('-')[1][:3] if '-' in k else k}:"
                        f"{int(v['count'])}"
                        for k, v in sorted(colls.items())
                        if not k.startswith("_"))
        note = rf.get("notes", "").split(";")[0]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {fmt_bytes(ms['temp_size_in_bytes'])} "
            f"| {fmt_bytes(ms['argument_size_in_bytes'])} "
            f"| {cstr} | {note} |")
    return "\n".join(out)


def roofline_table(rows: list[dict]) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | "
           "bottleneck | 6ND/traced | peak frac | one-line diagnosis |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok" or r["mesh"] != "single":
            continue
        rf = r["roofline"]
        diag = _diagnosis(rf)
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {rf['compute_s']:.3e} | {rf['memory_s']:.3e} "
            f"| {rf['collective_s']:.3e} | {rf['bottleneck']} "
            f"| {rf['useful_ratio']:.2f} | {rf['peak_fraction']:.1%} "
            f"| {diag} |")
    return "\n".join(out)


def _diagnosis(rf: dict) -> str:
    b = rf["bottleneck"]
    if b == "compute":
        if rf["useful_ratio"] < 0.55:
            return ("compute-bound but <55% useful: remat recompute + "
                    "causal-mask waste dominate — fused attention (K10) / "
                    "cheaper remat policy")
        return "compute-bound, healthy useful ratio — near-roofline"
    if b == "memory":
        return ("memory-bound: biggest lever is attention-logit / "
                "activation traffic (fused attention K10, bf16 "
                "intermediates)")
    return ("collective-bound: biggest lever is gradient/activation "
            "collective schedule (collective overlap, compression, layout)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="all",
                    choices=["single", "multi", "all"])
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    mesh = None if args.mesh == "all" else args.mesh
    rows = load(mesh, args.dir)
    print("## Dry-run\n")
    print(dryrun_table(rows))
    print("\n## Roofline (single pod, 256 devices; NVIDIA H100 SXM5 "
          "datasheet limits)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
