"""Puts the checkout's root (for ``cardbench``) and ``src`` (for the
program) on the import path, and hands tests small copies of the
benchmark's configurations."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def bench():
    from cardbench import harness
    return harness.Benchmark(ROOT)


def small_config(bench, cell: str) -> dict:
    """The cell's configuration at a size a CPU test run can hold: a
    Kronecker pool at scale 10."""
    cfg = copy.deepcopy(bench.config(bench.cell(cell)["config"]))
    if "scale" in cfg:
        cfg["scale"] = 10
    return cfg
