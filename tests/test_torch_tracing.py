"""The spans of a served request in the port, their profiler ranges, the
executor cache's hit counter and the histogram snapshot, on the CPU.

A dense-B request with a seeded reordering plan (RCM, fixed clusters)
goes through ``SpGEMMServer(device="cpu").submit``: its spans form the
tree ``request`` → ``validate``, ``fingerprint``, ``plan``, ``execute``
(→ ``digest``, ``upload``, [``pack``,] ``kernel`` → ``product``,
``copy``, ``unpermute``), ``guard``, and tracing adds no device sync.
"""
import numpy as np
import pytest
import torch

import repro_torch.device
from repro_torch.core.formats import HostCSR
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import NOOP_SPAN, Tracer, get_tracer
from repro_torch.planner import service
from repro_torch.planner.cost_model import Candidate
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner, _materialize
from repro_torch.resilience import faults, reset_policy
from repro_torch.resilience.errors import InvalidOperandError
from repro_torch.serve.engine import SpGEMMServer

SPAN_NAMES = ("request", "validate", "fingerprint", "plan", "execute",
              "digest", "upload", "kernel", "product", "copy", "unpermute",
              "guard")


@pytest.fixture(autouse=True)
def _fresh_state():
    tracer = get_tracer()
    reset_policy()
    faults.disarm()
    tracer.disable()
    tracer.clear()
    yield
    tracer.disable()
    tracer.clear()
    reset_policy()
    faults.disarm()


def _matrix(n=64, seed=3) -> HostCSR:
    """A symmetric integer-valued pattern that RCM reorders."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.08
    mask = mask | mask.T | np.eye(n, dtype=bool)
    vals = rng.integers(1, 4, (n, n)).astype(np.float32)
    return HostCSR.from_dense(np.where(mask, vals, 0.0).astype(np.float32))


def _dense_b(n, seed=4) -> np.ndarray:
    return np.random.default_rng(seed).integers(-2, 3, (n, 8)).astype(
        np.float32)


def _server(a: HostCSR, workload: str = "spmm") -> SpGEMMServer:
    """A server whose plan cache holds an RCM + fixed-cluster plan for
    ``a`` (SpMM by default): every request hits the plan and un-permutes
    C's rows (and for A², its columns)."""
    perm, bounds, mc, _ = _materialize(a, Candidate("rcm", "fixed"))
    assert perm is not None and not np.array_equal(perm, np.arange(a.nrows))
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(a), reorder="rcm", scheme="fixed",
                   reuse_hint=20, max_cluster=mc, perm=perm,
                   boundaries=bounds, workload=workload))
    return SpGEMMServer(Planner(cache=cache, device="cpu"))


def _traced(fn):
    """Run ``fn`` with the tracer on; the spans it recorded."""
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        fn()
    finally:
        tracer.disable()
    spans = tracer.spans()
    tracer.clear()
    return spans


def _children(spans, parent) -> list[str]:
    """The names of ``parent``'s children, in the order they opened."""
    kids = [sp for sp in spans if sp.parent_id == parent.span_id]
    return [sp.name for sp in sorted(kids, key=lambda sp: sp.t0)]


def _one(spans, name):
    (sp,) = [sp for sp in spans if sp.name == name]
    return sp


@pytest.mark.parametrize("exec_hit", [False, True])
def test_span_tree_of_a_plan_hit_dense_b_request(exec_hit):
    a = _matrix()
    b = _dense_b(a.nrows)
    srv = _server(a)
    if exec_hit:
        srv.submit(a, b)            # packs; the traced request hits
    resp = None

    def go():
        nonlocal resp
        resp = srv.submit(a, b)
    spans = _traced(go)
    assert resp.plan_cache_hit and resp.reorder == "rcm"
    np.testing.assert_array_equal(resp.result, a.to_dense() @ b)
    root = _one(spans, "request")
    assert root.parent_id == 0
    assert {sp.trace_id for sp in spans} == {root.trace_id}
    assert _children(spans, root) == ["validate", "fingerprint", "plan",
                                      "execute", "guard"]
    assert _children(spans, _one(spans, "execute")) == (
        ["digest", "upload", "kernel"] if exec_hit
        else ["digest", "upload", "pack", "kernel"])
    # plan holds nothing new, kernel only its three steps
    assert _children(spans, _one(spans, "plan")) == []
    assert _children(spans, _one(spans, "kernel")) == ["product", "copy",
                                                        "unpermute"]
    by_id = {sp.span_id: sp for sp in spans}
    for sp in spans:
        if sp.parent_id:
            up = by_id[sp.parent_id]
            assert up.t0 <= sp.t0
            assert sp.t0 + sp.duration <= up.t0 + up.duration + 1e-9


@pytest.mark.parametrize("workload", ["spmm", "a2"])
def test_the_copy_span_books_pageable_bytes_on_the_cpu(workload):
    a = _matrix()
    b = _dense_b(a.nrows) if workload == "spmm" else None
    srv = _server(a, workload)
    resp = None

    def go():
        nonlocal resp
        resp = srv.submit(a, b)
    spans = _traced(go)
    d = a.to_dense()
    np.testing.assert_array_equal(resp.result, d @ (d if b is None else b))
    assert _children(spans, _one(spans, "kernel")) == ["product", "copy",
                                                        "unpermute"]
    assert _one(spans, "copy").attrs == {"bytes": resp.result.nbytes,
                                         "pinned": False}


@pytest.mark.parametrize("reorder", ["original", "rcm"])
def test_a_sparse_c_hop_books_its_copy_and_to_csr_spans(reorder):
    """A chain hop on the sparse-C route: its ``kernel`` span holds the
    ``product``, the slabs' ``to_csr`` assembly (the live slabs and C's
    entries), the CSR arrays' ``copy`` (their bytes, pageable on the CPU)
    and, where the plan reorders, the ``unpermute``."""
    a = _matrix()
    perm, _, mc, _ = _materialize(a, Candidate(reorder, "pallas"))
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(a), reorder=reorder,
                   scheme="pallas", reuse_hint=20, max_cluster=mc,
                   perm=perm, workload="chain"))
    srv = SpGEMMServer(Planner(cache=cache, device="cpu"))
    resp = None

    def go():
        nonlocal resp
        resp = srv.submit(a, hops=1)
    spans = _traced(go)
    d = a.to_dense()
    assert resp.scheme == "pallas" and not resp.degraded
    np.testing.assert_array_equal(resp.result.to_dense(), d @ d)
    steps = ["product", "to_csr", "copy"] + (
        ["unpermute"] if reorder == "rcm" else [])
    assert _children(spans, _one(spans, "kernel")) == steps
    to_csr = _one(spans, "to_csr").attrs
    c = resp.result
    assert to_csr["c_nnz"] == c.nnz == np.count_nonzero(d @ d)
    assert to_csr["slabs"] > 0
    assert _one(spans, "copy").attrs == {
        "bytes": c.indptr.nbytes + c.indices.nbytes + c.data.nbytes,
        "pinned": False}


def test_a_guard_on_a_ladder_rung_sits_under_its_fallback():
    a = _matrix()
    b = _dense_b(a.nrows)
    srv = _server(a)
    resp = None

    def go():
        nonlocal resp
        with faults.injected(faults.FaultPlan(0, sites=["output"])):
            resp = srv.submit(a, b)
    spans = _traced(go)
    assert resp.degraded and resp.fallback_scheme == "rowwise"
    np.testing.assert_array_equal(resp.result, a.to_dense() @ b)
    root = _one(spans, "request")
    guards = [sp for sp in spans if sp.name == "guard"]
    fb = _one(spans, "fallback")
    assert sorted(sp.parent_id for sp in guards) == sorted(
        [root.span_id, fb.span_id])
    assert fb.parent_id == root.span_id


def test_a_rejected_operand_still_yields_a_request_span():
    a = _matrix()
    bad = HostCSR(a.indptr, a.indices,
                  np.where(np.arange(a.nnz) == 3, np.nan, a.data).astype(
                      np.float32), a.shape)
    srv = _server(a)
    rejects = obs_metrics.get_registry().counter("serve_rejects",
                                                 field="data")
    before = rejects.value

    def go():
        with pytest.raises(InvalidOperandError):
            srv.submit(bad, _dense_b(a.nrows))
    spans = _traced(go)
    assert rejects.value == before + 1
    assert [sp.name for sp in spans] == ["validate", "request"]
    assert _one(spans, "validate").parent_id == _one(spans,
                                                     "request").span_id


def _count_ranges(monkeypatch) -> list:
    """Count the profiler ranges the tracer opens."""
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    return opened


def test_disabled_tracer_records_nothing_and_opens_no_range(monkeypatch):
    assert Tracer().span("request") is NOOP_SPAN
    opened = _count_ranges(monkeypatch)
    a = _matrix()
    srv = _server(a)
    tracer = get_tracer()
    tracer.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        srv.submit(a, _dense_b(a.nrows))
    assert tracer.spans() == [] and opened == []
    names = {ev.name for ev in prof.events()}
    assert not names & set(SPAN_NAMES)


def test_enabled_tracer_without_a_profiler_opens_no_range(monkeypatch):
    opened = _count_ranges(monkeypatch)
    a = _matrix()
    srv = _server(a)
    spans = _traced(lambda: srv.submit(a, _dense_b(a.nrows)))
    assert {sp.name for sp in spans} >= set(SPAN_NAMES)
    assert opened == []


def test_span_names_appear_among_the_profiler_events(monkeypatch):
    opened = _count_ranges(monkeypatch)
    a = _matrix()
    srv = _server(a)
    srv.submit(a, _dense_b(a.nrows))
    prof = None

    def go():
        nonlocal prof
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            srv.submit(a, _dense_b(a.nrows))
    spans = _traced(go)
    ranges = [ev for ev in prof.events() if ev.name in SPAN_NAMES]
    assert {ev.name for ev in ranges} == set(SPAN_NAMES)
    assert sorted(opened) == sorted(sp.name for sp in spans)
    # function-scope records: no user annotation, which the profiler
    # would mirror onto the device's timeline as an event of its own
    assert not any(ev.is_user_annotation for ev in ranges)
    # each range on the profiler's clock lasts no longer than its span
    # plus the profiler's own overhead
    root = _one(spans, "request")
    (rng,) = [ev for ev in ranges if ev.name == "request"]
    assert (rng.time_range.end - rng.time_range.start) * 1e-6 <= \
        root.duration + 0.05


def test_profiler_range_needs_a_recording_profiler():
    assert obs_trace._profiler_range("x") is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rng = obs_trace._profiler_range("x")
        assert rng is not None
        rng.__exit__(None, None, None)


def test_tracing_adds_no_device_sync(monkeypatch):
    calls = []
    real = repro_torch.device.synchronize

    def counting(dev):
        calls.append(dev)
        return real(dev)
    monkeypatch.setattr(repro_torch.device, "synchronize", counting)
    monkeypatch.setattr(service, "synchronize", counting)
    a = _matrix()
    b = _dense_b(a.nrows)
    srv = _server(a)
    srv.submit(a, b)                 # packs outside both counts
    del calls[:]
    srv.submit(a, b)
    off = len(calls)
    del calls[:]
    _traced(lambda: srv.submit(a, b))
    assert off >= 1 and len(calls) == off


def test_chrome_export_holds_the_request_tree(tmp_path):
    import json
    a = _matrix()
    srv = _server(a)
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        srv.submit(a, _dense_b(a.nrows))
        path = tmp_path / "trace.json"
        assert tracer.export_chrome(str(path)) == len(tracer.spans())
    finally:
        tracer.disable()
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev["ph"] == "X"]
    assert sorted(ev["name"] for ev in events) == sorted(
        SPAN_NAMES + ("pack",))
    ids = {ev["args"]["span_id"]: ev["name"] for ev in events}
    parent = {ev["name"]: ids.get(ev["args"]["parent_id"])
              for ev in events}
    assert parent["request"] is None
    assert parent["unpermute"] == "kernel" and parent["guard"] == "request"
    assert len({ev["tid"] for ev in events}) == 1


def test_exec_cache_counts_a_miss_then_a_hit():
    snap = obs_metrics.get_registry().snapshot

    def counts():
        s = snap()
        return s.get("exec_cache_packs", 0), s.get("exec_cache_hits", 0)
    a = _matrix()
    b = _dense_b(a.nrows)
    srv = _server(a)
    p0, h0 = counts()
    srv.submit(a, b)
    p1, h1 = counts()
    srv.submit(a, b)
    p2, h2 = counts()
    assert (p1 - p0, h1 - h0) == (1, 0)
    assert (p2 - p1, h2 - h1) == (0, 1)


def test_exec_cache_hits_is_declared_as_a_counter():
    assert obs_metrics.METRIC_CATALOG["exec_cache_hits"][0] == "counter"


def test_histogram_snapshot_keeps_its_five_keys():
    h = obs_metrics.Histogram()
    assert h.snapshot() == {"count": 0}
    for v in (3.0, 1.0, 2.0):
        h.observe(v)
    assert h.snapshot() == {"count": 3, "sum": 6.0, "mean": 2.0,
                            "min": 1.0, "max": 3.0}
