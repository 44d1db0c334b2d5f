"""A copy of the benchmark with one more configuration, traffic kind,
traffic mix, cell and per-layer metric, each added as a file (and the
cell and metric as entries of BENCHMARK.json), is run without an edit to
any file the benchmark already has."""
import json
import os
import shutil

import pytest

from cardbench import harness
from conftest import ROOT

KIND = '''
import time
from cardbench import harness, reference


class Traffic:
    """A closed loop of A-squared requests over the pool."""

    def __init__(self, config, mix, seed, system):
        self.config, self.mix, self.seed, self.system = (config, mix, seed,
                                                         system)

    def setup(self):
        self.pool = [a for g in harness.pool(self.config, self.seed)
                     for a in g]
        self.ops = [self.system.operand(a) for a in self.pool]
        self.server = self.system.server()
        self.kept = []

    def run(self, window):
        k = 0
        while window.running():
            i = k % len(self.ops)
            window.submitted()
            t0 = time.perf_counter()
            out = self.server.submit(self.ops[i]).result
            window.served(t0, time.perf_counter())
            if k < 4:
                self.kept.append((i, out))
            window.boundary()
            k += 1

    def batching(self):
        return None

    def release(self):
        self.server = None

    def check(self):
        err = max(reference.max_abs_err(out, reference.product(self.pool[i]))
                  for i, out in self.kept)
        return {"max_abs_err": [err, 0.0]}
'''

READER = '''
def read(obs):
    return float(obs.requests) if obs.requests else None
'''


@pytest.fixture
def copy_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "cardbench"), root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in _files(root)}
    d = root / "cardbench"
    (d / "configs" / "caveman-small.json").write_text(json.dumps({
        "n": 96, "cave": 12, "values": [1, 2, 3], "dtype": "float32",
        "pool": [{"generator": "caveman", "args": ["n", "cave"],
                  "count": 3}]}))
    (d / "traffic" / "closed_a2.py").write_text(KIND)
    (d / "traffic" / "a2-closed.json").write_text(
        json.dumps({"kind": "closed_a2"}))
    (d / "metrics" / "extra.requests.py").write_text(READER)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "caveman-small", "source": "x",
                            "file": "cardbench/configs/caveman-small.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "caveman-a2", "config":
                              "caveman-small", "traffic": "a2-closed",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "extra.requests", "unit": "req",
                              "better": "higher", "source":
                              "program_counter", "layer": "x",
                              "moves": "throughput_rps",
                              "workloads": ["caveman-a2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    yield root, before


def _files(root):
    return sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs if "__pycache__" not in dp)


@pytest.mark.parametrize("trace", [False, True])
def test_added_files_are_found(copy_root, trace):
    root, before = copy_root
    bench = harness.Benchmark(str(root))
    res = harness.run("caveman-a2", 17, 0.4, trace, device="cpu",
                      t_start=0.0, bench=bench)
    assert res["correct"], res["checks"]
    if trace:
        assert res["metrics"]["extra.requests"]["value"] >= 1
        assert "planner.plan_ms" not in res["metrics"]
    else:
        # every end-to-end metric not kept to other cells
        assert set(res["metrics"]) == {"latency_p50_ms", "throughput_rps",
                                       "setup_s"}
    # every file the benchmark already had is as it was
    for path, data in before.items():
        if not path.endswith("BENCHMARK.json"):
            assert open(path, "rb").read() == data, path


def test_existing_cells_keep_their_metrics(copy_root):
    root, _ = copy_root
    bench = harness.Benchmark(str(root))
    names = {m["name"] for m in bench.metrics("kron18-spmm-b64", True)}
    assert "extra.requests" not in names
    assert names == {"planner.plan_ms", "planner.runner_ms",
                     "product_roofline", "device.idle_pct"}
