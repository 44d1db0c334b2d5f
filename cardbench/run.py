"""Run one cell of the benchmark on the card and print its result line.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``src/repro_torch``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which are also the last lines of standard
error. Without a card, or with fewer cards than the cell asks for, it
prints no result and exits 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# top-level module names the process may not hold once the window has
# closed: JAX, its libraries, and the JAX package the port was made from
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def _number(v):
    return v if math.isfinite(v) else str(v)


def _prepare() -> None:
    """Import paths for the benchmark and the program, and the program's
    kernel and extension caches inside the checkout at fixed paths, so
    that only a checkout's first run builds. Before torch is imported."""
    cache = os.path.join(ROOT, "build", "cardbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    _prepare()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench import harness, roofline
    bench = harness.Benchmark(ROOT)
    chips = int(bench.cell(args.workload).get("chips", 1))
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"cardbench: needs {chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START,
                         bench=bench)
    found = forbidden_modules()
    if found:
        print(f"cardbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = roofline.power_limit_w()
    checks = result.pop("checks")
    result["checks"] = {k: [_number(v), _number(lim)]
                        for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
