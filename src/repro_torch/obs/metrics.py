"""Unified metrics registry: host serving events + device traffic counters.

One process-global :class:`MetricsRegistry` holds every counter, gauge
and histogram the serving stack emits. Two name spaces, one table:

* **host metrics** — request/plan/pack/execute events, plan-cache and
  exec-cache accounting, audit state. Declared in :data:`METRIC_CATALOG`
  below; creating an instrument with an undeclared name (or the wrong
  kind) raises — the catalog is the single source of truth the
  ``docs/observability.md`` metric table renders and ``make docs-check``
  keeps in two-way sync.
* **device counters** — the traffic counters already declared (with
  units) in ``repro_torch.core.formats::COUNTER_UNITS`` (``b_bytes``,
  ``b_tile_refetches``, ``c_bytes_sparse``, …). They enter the registry
  through :meth:`MetricsRegistry.emit_device_counters`, which validates
  every emitted name against that table and accumulates it under the
  ``device_<name>`` catalog entry. Counter-kind entries accumulate
  across launches; ratio-unit entries are gauges (last value wins).

Computing device counters costs host time (O(pairs) numpy work), so the
kernel layer only emits them when ``registry.device_emission`` is on.

Histograms keep count/sum/min/max only — constant memory on a
long-running server; percentiles are the reader's, over its own window.

Labels: ``registry.counter("serve_requests", tenant="team-x")`` keys the
instrument by name + sorted labels; empty-string label values are
dropped (the default tenant does not clutter the snapshot).
"""
from __future__ import annotations

import threading

from repro_torch.core.formats import COUNTER_UNITS

__all__ = ["METRIC_CATALOG", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "get_registry"]


# -- the catalog -------------------------------------------------------------
# name -> (kind, description). Host-side entries are hand-declared here;
# device_<counter> entries are derived from COUNTER_UNITS so the two
# tables can never drift apart. docs/observability.md renders this dict
# and tools/check_docs.py asserts the two stay in two-way sync.

_HOST_METRICS: dict[str, tuple[str, str]] = {
    "serve_requests": (
        "counter", "requests received by SpGEMMServer (count)"),
    "serve_request_s": (
        "histogram", "end-to-end request wall time (seconds)"),
    "serve_plan_s": (
        "histogram", "per-request planning wall time (seconds)"),
    "serve_execute_s": (
        "histogram", "per-request execute wall time, device-synced "
        "(seconds)"),
    "plan_total": (
        "counter", "Planner.plan calls, hits and misses (count)"),
    "plan_cache_hits": (
        "gauge", "PlanCache hits, mirrored from PlanCache.stats (count)"),
    "plan_cache_misses": (
        "gauge", "PlanCache misses, mirrored from PlanCache.stats (count)"),
    "plan_cache_evictions": (
        "gauge", "PlanCache evictions, mirrored from PlanCache.stats "
        "(count)"),
    "plan_cache_entries": (
        "gauge", "live PlanCache entries (count)"),
    "plan_cache_bytes": (
        "gauge", "PlanCache budget usage, memory + disk (bytes)"),
    "exec_cache_packs": (
        "counter", "operand packings on exec-cache misses (count)"),
    "exec_cache_hits": (
        "counter", "packed operands found in the exec cache (count)"),
    "pack_layout_hits": (
        "counter", "exec-cache misses packed from their pattern's cached "
        "value layout: values uploaded and scattered only (count)"),
    "exec_cache_entries": (
        "gauge", "packed operand sets resident in the exec cache (count)"),
    "exec_cache_bytes": (
        "gauge", "tensor bytes the exec cache's packed operands hold "
        "(bytes)"),
    "kernel_tier_products": (
        "counter", "products executed by a plan of scheme pallas, on the "
        "hand-written kernels; ladder rungs, batched launches and chain "
        "hops each under their own plan (count)"),
    "gather_tier_products": (
        "counter", "products executed by a plan of scheme rowwise, fixed, "
        "variable or hierarchical, on the gather/scatter tier (count)"),
    "host_copies": (
        "counter", "results copied from the device to host numpy, by "
        "memory — pinned (page-locked, from the card) / pageable "
        "(count)"),
    "kernel_launches": (
        "counter", "Sp×Sp kernel dispatches, by variant label "
        "(count)"),
    "chain_hops": (
        "counter", "chain-workload hops executed (count)"),
    "sparse_c_slab_bytes": (
        "counter", "bytes of the live CompactedC slabs the sparse-C "
        "products of chain hops wrote, one addition per product "
        "(bytes)"),
    "sparse_c_entries": (
        "counter", "entries of C the sparse-C products of chain hops "
        "returned as CSR, one addition per product (count)"),
    "pipeline_stage_s": (
        "histogram", "planned sparse pipeline stage wall time (seconds)"),
    "audit_records": (
        "counter", "drift-audit samples recorded (count)"),
    "audit_flagged": (
        "gauge", "fingerprints currently beyond the drift threshold "
        "(count)"),
    "serve_rejects": (
        "counter", "requests rejected by boundary validation, by reason "
        "(count)"),
    "serve_fallbacks": (
        "counter", "executions recovered by a degradation-ladder rung, "
        "by failing scheme (count)"),
    "quarantine": (
        "gauge", "(fingerprint, scheme, variant) triples currently "
        "quarantined by the circuit breaker (count)"),
    "plan_cache_corrupt": (
        "counter", "damaged plan-cache disk entries evicted "
        "(miss-plus-evict), by reason (count)"),
    "probe_skips": (
        "counter", "measured-mode probe candidates skipped by the "
        "wall-clock cap (count)"),
    "faults_injected": (
        "counter", "chaos-harness faults fired, by site — always 0 in "
        "production (count)"),
    "serve_shed": (
        "counter", "requests shed at the front-end admission boundary, "
        "by reason (count)"),
    "serve_deadline_miss": (
        "counter", "request deadlines missed, by stage — admission / "
        "queue / completion (count)"),
    "serve_queue_depth": (
        "gauge", "front-end bounded-queue depth after the last "
        "enqueue/dequeue (count)"),
    "serve_queue_wait_s": (
        "histogram", "time admitted requests spent queued before "
        "execution (seconds)"),
    "serve_coalesced": (
        "counter", "requests coalesced onto an identical in-flight "
        "request's single-flight latch (count)"),
    "serve_downgrades": (
        "counter", "cold fingerprints proactively admitted on the "
        "identity rung under queue pressure (count)"),
    "serve_recalibrations": (
        "counter", "scheduled cost-model refits from live audit "
        "samples, by outcome — applied / skipped (count)"),
    "serve_batches": (
        "counter", "block-diagonal batched launches executed by the "
        "front-end, by outcome — served / disbanded (count)"),
    "batch_occupancy": (
        "histogram", "members packed per batched launch (count)"),
    "batch_launch_amortization": (
        "gauge", "front-end requests served per kernel launch — 1.0 "
        "unbatched, higher as batching amortizes dispatch (ratio)"),
}

METRIC_CATALOG: dict[str, tuple[str, str]] = dict(_HOST_METRICS)
for _name, _unit in COUNTER_UNITS.items():
    _kind = "gauge" if "(ratio)" in _unit else "counter"
    METRIC_CATALOG[f"device_{_name}"] = (
        _kind, f"device traffic, accumulated from COUNTER_UNITS: {_unit}")


# -- instruments -------------------------------------------------------------


class Counter:
    """Monotonically increasing count (an increment is atomic: the
    serving front-end's worker threads share the registry)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-value-wins instantaneous reading."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Histogram:
    """count/sum/min/max of the observed values."""

    __slots__ = ("count", "total", "min", "max", "_lock")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def snapshot(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            count, total, lo, hi = self.count, self.total, self.min, self.max
        return {"count": count, "sum": total, "mean": total / count,
                "min": lo, "max": hi}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# -- the registry ------------------------------------------------------------


class MetricsRegistry:
    """Catalog-validated instrument store (process-global by default)."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()
        # device-counter emission is opt-in: computing the counters is
        # O(pairs) host work the steady-state hot path must not pay
        self.device_emission = False

    @staticmethod
    def _key(name: str, labels: dict) -> str:
        kept = {k: v for k, v in labels.items() if v != ""}
        if not kept:
            return name
        inner = ",".join(f"{k}={kept[k]}" for k in sorted(kept))
        return f"{name}{{{inner}}}"

    def _get(self, name: str, kind: str, labels: dict):
        entry = METRIC_CATALOG.get(name)
        if entry is None:
            raise ValueError(
                f"metric '{name}' is not declared in METRIC_CATALOG "
                "(host metrics) nor derived from COUNTER_UNITS (device "
                "counters) — declare it before emitting")
        if entry[0] != kind:
            raise ValueError(f"metric '{name}' is a {entry[0]}, "
                             f"not a {kind}")
        key = self._key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(key, _KINDS[kind]())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, "counter", labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, "gauge", labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(name, "histogram", labels)

    def emit_device_counters(self, counters: dict, **labels) -> None:
        """Accumulate one kernel launch's traffic counters.

        Every name must be declared in
        ``repro_torch.core.formats::COUNTER_UNITS`` — an undeclared counter is
        a hard error, the same discipline ``benchmarks/bench_kernels``
        asserts before printing its table.
        """
        unknown = sorted(k for k in counters if k not in COUNTER_UNITS)
        if unknown:
            raise ValueError(
                f"counters missing from COUNTER_UNITS: {unknown} — add "
                "them (with units) to repro_torch.core.formats.COUNTER_UNITS")
        for name, value in counters.items():
            dev = f"device_{name}"
            if METRIC_CATALOG[dev][0] == "gauge":
                self.gauge(dev, **labels).set(value)
            else:
                self.counter(dev, **labels).inc(value)

    def snapshot(self) -> dict:
        """Point-in-time view: {instrument key: value or histogram dict}."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {key: inst.snapshot() for key, inst in items}

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every instrumented module shares."""
    return _REGISTRY
