"""The benchmark harness: one cell, one seed, one measured window.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* ``configs[i].file`` — the configuration (a JSON file of sizes and the
  pool of matrices the traffic draws from);
* ``cardbench/traffic/<traffic>.json`` — the traffic mix's parameters,
  whose ``kind`` names the traffic code ``cardbench/traffic/<kind>.py``;
* ``cardbench/metrics/<metric>.py`` — a reader with ``read(obs)``, which
  takes one per-layer metric from an :class:`Observation` and returns
  ``None`` where it finds nothing to read.

A run sets up the traffic (inputs from the seed, servers, warm-up), then
measures for ``seconds``: the traffic calls :meth:`Window.served` for
every request and :meth:`Window.boundary` between units of work, where a
traced run starts and stops the profiler. After the window closes the
traffic checks its sampled answers against the reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Optional

import numpy as np

from cardbench import graphs, profiling

__all__ = ["HERE", "ROOT", "Benchmark", "Reservoir", "Window",
           "Observation", "pool", "run", "PROFILE_AFTER_S", "PROFILE_S"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the traced run profiles the device from the first boundary this far
# into the window, for this long (then to the next boundary)
PROFILE_AFTER_S = 2.0
PROFILE_S = 2.0
# the mark whose start aligns the profiler's clock with the host's
CLOCK_MARK = "cardbench.clock"


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file at ``path`` as a module called ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Benchmark:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = read_json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "cardbench")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return read_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return read_json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def kind(self, kind: str):
        return load_module(os.path.join(self.dir, "traffic", f"{kind}.py"),
                           f"cardbench_traffic_{kind}")

    def reader(self, metric: str):
        return load_module(os.path.join(self.dir, "metrics", f"{metric}.py"),
                           "cardbench_metric_" + metric.replace(".", "_"))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics,
        or with ``trace`` its per-layer ones."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell in m.get("workloads", [cell])]


def pool(config: dict, seed: int) -> list[list[graphs.Csr]]:
    """The configuration's matrices for ``seed``, one list per pool group.

    A group names its ``generator``, the configuration's keys that are
    its arguments (``args``), and a ``count``: member ``j`` is the
    generator's output for seed ``count * seed + j``. With ``relabel``
    its vertices are renamed by a permutation drawn from the seed; its
    values are drawn from ``values`` and stored as ``dtype``."""
    groups = []
    for gi, group in enumerate(config["pool"]):
        gen = graphs.GENERATORS[group["generator"]]
        args = {k: config[k] for k in group["args"]}
        count = int(group["count"])
        members = []
        for j in range(count):
            a = gen(**args, seed=count * seed + j)
            rng = np.random.default_rng([seed, gi, j])
            if config.get("relabel", False):
                a = graphs.relabel(a, rng.permutation(a.n))
            members.append(graphs.integer_values(a, rng, config["values"],
                                                 config["dtype"]))
        groups.append(members)
    return groups


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn
    from ``seed``: the answers that are checked after the window."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng([seed, 0x5A])

    def slot(self) -> Optional[int]:
        """Where the next item goes (``None``: not kept). Call once per
        item, then :meth:`put` it there when it is kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            return i
        j = int(self._rng.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        if slot < len(self.items):
            self.items[slot] = item
        else:
            self.items.append(item)


def _profiler():
    import torch
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


class Window:
    """The measured window: request latencies, failures, and in a traced
    run the profiled stretch."""

    def __init__(self, seconds: float, *, profile: bool = False):
        self.seconds = float(seconds)
        self.profile = profile
        self.latencies: list[float] = []
        self.attempted = 0
        self.failed = 0
        self.t_open = self.t_close = 0.0
        self.least_s = 0.0          # work's least time, profiled requests
        self.profiled = None        # profiling.Profile once taken
        self._prof = None
        self._stopped = None        # (profiler, end) until the close
        self._mark = 0.0            # host time the stretch began

    def warm(self) -> None:
        """Start and read the profiler once on a trivial op, in set-up:
        its first start on a card takes seconds."""
        if not self.profile:
            return
        import torch
        with _profiler() as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.events()

    def open(self) -> None:
        self.t_open = time.perf_counter()

    def running(self) -> bool:
        return time.perf_counter() < self.t_open + self.seconds

    def submitted(self) -> None:
        self.attempted += 1

    def served(self, t_submit: float, t_done: float,
               least_s: Optional[float] = None) -> None:
        self.latencies.append(t_done - t_submit)
        if self._prof is not None and least_s is not None:
            self.least_s += least_s

    def fail(self) -> None:
        self.failed += 1

    def boundary(self) -> None:
        """Between units of work: start or stop the profiler when due."""
        if not self.profile or self._stopped is not None:
            return
        now = time.perf_counter()
        if self._prof is None and now >= self.t_open + PROFILE_AFTER_S:
            self._start()
        elif self._prof is not None and now >= self._mark + PROFILE_S:
            self._stop()

    def close(self) -> None:
        if self._prof is not None:
            self._stop()
        self.t_close = time.perf_counter()
        if self._stopped is not None:
            # reading the trace waits until the window has closed
            prof, t1 = self._stopped
            self._stopped = None
            self.profiled = profiling.from_torch(prof, CLOCK_MARK,
                                                 self._mark, self._mark, t1)

    def _start(self) -> None:
        import torch
        self._prof = _profiler()
        self._prof.__enter__()
        torch.cuda.synchronize()
        with torch.profiler.record_function(CLOCK_MARK):
            self._mark = time.perf_counter()

    def _stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self._stopped = (prof, t1)

    @property
    def wall_s(self) -> float:
        return self.t_close - self.t_open


@dataclasses.dataclass
class Observation:
    """What a traced run hands each per-layer reader.

    ``spans``: the program's spans of the window as ``(name, start_s,
    end_s)`` on the host's clock; ``counters_before``/``_after``: the
    program's metrics registry around the window; ``batching_before``/
    ``_after``: the front end's batching counts (``None`` without a front
    end); ``profile``: the profiled stretch (``None`` when not taken);
    ``least_s``: the least time the card needs for the work of the
    requests inside the stretch."""

    requests: int
    spans: list
    counters_before: dict
    counters_after: dict
    batching_before: Optional[dict]
    batching_after: Optional[dict]
    profile: Optional[profiling.Profile]
    least_s: float

    def span_s(self, *names: str) -> float:
        return sum(e - s for n, s, e in self.spans if n in names)

    def has_span(self, *names: str) -> bool:
        return any(n in names for n, _, _ in self.spans)


def _spans(tracer, offset: float) -> list:
    return [(sp.name, sp.t0 + offset, sp.t0 + offset + sp.duration)
            for sp in tracer.spans()]


def _device(device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": device, "kind": device, "count": chips,
                "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def end_to_end(window: Window, setup_s: float) -> dict:
    """Every end-to-end metric the harness knows, by name."""
    lat = np.asarray(window.latencies, dtype=np.float64) * 1e3
    out = {"setup_s": setup_s}
    if lat.size:
        out["latency_p50_ms"] = float(statistics.median(lat))
        out["latency_p95_ms"] = float(np.percentile(lat, 95))
    if window.wall_s > 0:
        out["throughput_rps"] = lat.size / window.wall_s
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device: str, t_start: float, bench: Optional[Benchmark] = None,
        system=None, config: Optional[dict] = None,
        mix: Optional[dict] = None) -> dict:
    """One run of a cell: the result line's fields, with ``checks`` (each
    compared number beside its limit) last.

    ``system`` replaces the program (the control); ``config`` and ``mix``
    replace the cell's files (tests run them at small sizes)."""
    bench = bench or Benchmark()
    seed = int(seed) % (1 << 63)
    cell = bench.cell(cell_name)
    config = config if config is not None else bench.config(cell["config"])
    mix = mix if mix is not None else bench.traffic(cell["traffic"])
    if system is None:
        from cardbench.system import Program
        system = Program(device)
    traffic = bench.kind(mix["kind"]).Traffic(config, mix, seed, system)
    t_setup = time.perf_counter()
    traffic.setup()
    t_ready = time.perf_counter()

    tracer = system.tracer() if trace else None
    profile = trace and device == "cuda"
    window = Window(seconds, profile=profile)
    window.warm()
    counters0 = system.counters()
    batching0 = traffic.batching()
    offset = 0.0
    if tracer is not None:
        tracer.clear()
        tracer.enable(capacity=2_000_000)
        with tracer.span(CLOCK_MARK):
            t_mark = time.perf_counter()
        offset = t_mark - tracer.spans()[-1].t0
    window.open()
    setup_s = window.t_open - t_start
    print(f"cardbench: set-up {setup_s:.3f} s: start and imports "
          f"{t_setup - t_start:.3f} s, inputs, servers and warm-up "
          f"{t_ready - t_setup:.3f} s", file=sys.stderr)
    traffic.run(window)
    window.close()
    spans = []
    if tracer is not None:
        tracer.disable()
        spans = [sp for sp in _spans(tracer, offset) if sp[0] != CLOCK_MARK]
        tracer.clear()
    counters1 = system.counters()
    batching1 = traffic.batching()
    dev = _device(device, int(cell.get("chips", 1)))
    traffic.release()
    checks = traffic.check()
    checks["failed"] = [window.failed, 0]

    if trace:
        obs = Observation(len(window.latencies), spans, counters0, counters1,
                          batching0, batching1, window.profiled,
                          window.least_s)
        metrics = {}
        for m in bench.metrics(cell_name, True):
            value = bench.reader(m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if window.profiled is not None:
            dev["busy_s"] = profiling.busy_s(window.profiled)
            dev["window_s"] = window.profiled.window_s
    else:
        e2e = end_to_end(window, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics(cell_name, False)
                   if m["name"] in e2e}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev}
    if trace and window.profiled is not None:
        result["breakdown"] = {
            "device_ops": profiling.top_ops(window.profiled),
            "idle_gaps": profiling.gaps_by_span(window.profiled, spans)}
    result["checks"] = checks
    return result
