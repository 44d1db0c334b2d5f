"""The port's async serving front-end against the JAX package's, and
under worker threads.

* **Parity** — the scenarios of ``tests/test_serving_frontend.py`` run
  through both packages' ``AsyncSpGEMMServer`` with ``workers=0`` and a
  fake clock: admission and shedding (capacity, per tenant, shutdown),
  deadlines by stage (admission shed, admission downgrade, queue expiry,
  completion overrun, unknown cost), coalescing, watermark pressure
  (downgrade, graduation, hot fingerprints, hysteresis), live reuse
  hints, the scheduled recalibration, and a burst under injected faults
  (seeds 0, 1 and 2). Per ticket the two agree on the result (integer
  values: exact), the response fields and the structured errors; the
  counters and the front-end's stats agree too.
* **Threads** — ``workers=4`` on one CPU server, with an exec-cache byte
  cap small enough to evict on every request and a shortened switch
  interval: every ticket resolves, equal to the dense product, and
  nothing degrades. The planner's shared state (exec cache, plan cache,
  drift auditor) is hammered directly too: each raised ``dictionary
  changed size during iteration`` or a ``KeyError`` before it took a
  lock.
"""
import sys
import threading

import numpy as np
import pytest

from test_torch_batching import (PORT, REF, SEEDS, SIDES, FakeClock,
                                 accounting, agree, counters, frontend,
                                 int_dense, outcome, _fresh_state)  # noqa: F401

import repro.planner.calibration as ref_calibration
import repro.planner.cost_model as ref_cost
import repro_torch.planner.calibration as port_calibration
import repro_torch.planner.cost_model as port_cost
from repro.planner.features import extract_features as ref_features
from repro_torch.planner.features import extract_features as port_features
from repro_torch.obs.audit import DriftAuditor
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner
from repro_torch.resilience import ResiliencePolicy
from repro_torch.serve.batcher import BatchPolicy
from repro_torch.serve.engine import SpGEMMServer
from repro_torch.serve.frontend import AsyncSpGEMMServer


def block_diag_pattern(side, seed):
    """``gen_block_diag(256, block=8)``'s pattern (the JAX suite's planned
    pattern: hierarchical at a high reuse hint, rowwise at 1) with
    integer values, so the two packages' sums are exact in any order."""
    h = side.gen_block_diag(256, block=8, seed=seed)
    data = np.random.default_rng(seed).integers(1, 4, h.nnz)
    return side.HostCSR(h.indptr, h.indices, data.astype(np.float32),
                        h.shape)


def _result(side, fe, tickets, oracles):
    obs = [outcome(t) for t in tickets]
    return ({"tickets": [o for o, _ in obs], **accounting(side, fe)},
            [r for _, r in obs], oracles)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def _capacity(side):
    dense = [int_dense(64, seed=i) for i in (0, 1, 2)]
    fe = frontend(side, FakeClock(), capacity=3)
    tickets = [fe.submit(side.HostCSR.from_dense(d)) for d in dense]
    with pytest.raises(side.resilience.OverloadError) as ei:
        fe.submit(side.HostCSR.from_dense(int_dense(64, seed=99)))
    shed = (ei.value.reason, ei.value.depth, ei.value.limit,
            fe.queue.depth())
    retired = fe.pump()
    obs = _result(side, fe, tickets, [d @ d for d in dense])
    obs[0].update(shed=shed, retired=retired)
    return obs


def _tenant(side):
    dense = [int_dense(64, seed=i) for i in (0, 1, 2)]
    fe = frontend(side, FakeClock(), capacity=4, tenant_capacity=1)
    tickets = [fe.submit(side.HostCSR.from_dense(dense[0]),
                         tenant="flooder")]
    with pytest.raises(side.resilience.OverloadError) as ei:
        fe.submit(side.HostCSR.from_dense(dense[1]), tenant="flooder")
    shed = (ei.value.reason, ei.value.tenant)
    tickets.append(fe.submit(side.HostCSR.from_dense(dense[2]),
                             tenant="polite"))
    depth = fe.queue.depth_of("flooder")
    retired = fe.pump()
    obs = _result(side, fe, tickets, [dense[0] @ dense[0],
                                      dense[2] @ dense[2]])
    obs[0].update(shed=shed, depth=depth, retired=retired)
    return obs


def _shutdown(side):
    fe = frontend(side, FakeClock(), capacity=4)
    t1 = fe.submit(side.HostCSR.from_dense(int_dense(64, seed=0)))
    fe.close(drain=False)
    with pytest.raises(side.resilience.OverloadError):
        fe.submit(side.HostCSR.from_dense(int_dense(64, seed=1)))
    return _result(side, fe, [t1], [None])


ADMISSION = {"capacity": _capacity, "tenant": _tenant,
             "shutdown": _shutdown}


@pytest.mark.parametrize("case", sorted(ADMISSION))
def test_admission_sheds_like_the_jax_package(case):
    obs = agree(ADMISSION[case])
    if case == "capacity":
        assert obs["shed"] == ("capacity", 3, 3, 3) and obs["retired"] == 3
        assert obs["counters"]["serve_shed{reason=capacity}"] == 1
    elif case == "tenant":
        assert obs["shed"] == ("tenant_depth", "flooder")
        assert obs["depth"] == 1 and obs["retired"] == 2
    else:
        assert obs["tickets"][0]["reason"] == "shutdown"


# ---------------------------------------------------------------------------
# deadlines by stage
# ---------------------------------------------------------------------------


def _deadline(side, case):
    clock = FakeClock()
    fe = frontend(side, clock, capacity=4)
    dense = int_dense(64, seed=0)
    a = side.HostCSR.from_dense(dense)
    fp = fe._fingerprint(a)
    extra = {}
    if case in ("shed", "downgrade"):
        fe.estimator.note_service(fp, 2.0)            # full path: 2 s
    if case == "downgrade":
        fe.estimator.note_service(fp, 0.1, downgraded=True)
    if case == "overrun":
        inner = fe.server.submit

        def slow_submit(*args, **kwargs):
            clock.advance(9.0)                         # execution overran
            return inner(*args, **kwargs)
        fe.server.submit = slow_submit
    budget = {"shed": 0.5, "downgrade": 0.5, "queue": 5.0, "overrun": 5.0,
              "unknown": 1e-6}[case]
    if case == "shed":
        with pytest.raises(side.resilience.DeadlineExceededError) as ei:
            fe.submit(a, deadline_s=budget)
        extra["shed"] = (ei.value.stage, ei.value.predicted_s)
        tickets = []
    else:
        tickets = [fe.submit(a, deadline_s=budget)]
    if case == "queue":
        clock.advance(10.0)
    fe.pump()
    if case == "queue":
        extra["waited_s"] = tickets[0].error().waited_s
    obs = _result(side, fe, tickets, [dense @ dense] * len(tickets))
    obs[0].update(extra)
    return obs


@pytest.mark.parametrize("case", ("shed", "downgrade", "queue", "overrun",
                                  "unknown"))
def test_deadlines_by_stage_like_the_jax_package(case):
    obs = agree(_deadline, case)
    c = obs["counters"]
    if case == "shed":
        assert obs["shed"] == ("admission", 2.0)
        assert c["serve_deadline_miss{stage=admission}"] == 1
        assert c["serve_shed{reason=deadline}"] == 1
    elif case == "downgrade":
        t, = obs["tickets"]
        assert t["downgraded"] and t["scheme"] == "rowwise"
        assert c["serve_downgrades"] == 1
    elif case == "queue":
        assert obs["tickets"][0]["stage"] == "queue"
        assert obs["waited_s"] == 10.0
    elif case == "overrun":
        assert obs["tickets"][0]["deadline_missed"]
        assert c["serve_deadline_miss{stage=completion}"] == 1
    else:
        assert "error" not in obs["tickets"][0]


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------


def _coalesce(side, same_values):
    dense = int_dense(64, seed=3 if same_values else 4)
    a = side.HostCSR.from_dense(dense)
    second = a if same_values else side.HostCSR(
        a.indptr, a.indices, a.data * 2.0, a.shape)
    fe = frontend(side, FakeClock(), capacity=4)
    tickets = [fe.submit(a), fe.submit(second)]
    if same_values:
        tickets.append(fe.submit(a))
    fe.pump()
    oracles = ([dense @ dense] * 3 if same_values
               else [dense @ dense, 4.0 * (dense @ dense)])
    obs = _result(side, fe, tickets, oracles)
    obs[0]["executions"] = (fe.server.requests
                            + fe.stats()["batching"]["batched_members"])
    return obs


@pytest.mark.parametrize("same_values", (True, False),
                         ids=("identical", "same_pattern_new_values"))
def test_coalescing_like_the_jax_package(same_values):
    obs = agree(_coalesce, same_values)
    flags = [t["coalesced"] for t in obs["tickets"]]
    if same_values:
        assert flags == [False, True, True] and obs["executions"] == 1
        assert obs["counters"]["serve_coalesced"] == 2
    else:
        assert flags == [False, False] and obs["executions"] == 2


# ---------------------------------------------------------------------------
# watermark pressure
# ---------------------------------------------------------------------------


def _warm(side, fe, clock, a):
    fp = fe._fingerprint(a)
    for _ in range(60):                    # ~10 arrivals/s for 6 s
        fe.estimator.observe(fp)
        clock.advance(0.1)
    return fe.estimator.reuse_hint(fp)


def _pressure(side, case):
    clock = FakeClock()
    fe = frontend(side, clock, capacity=4)
    extra = {}
    if case == "hysteresis":
        fe.server.planner.resilience.watermarks = \
            side.resilience.Watermarks(high=0.75, low=0.5)
        dense = [int_dense(64, seed=100 + i) for i in range(3)] + [
            int_dense(64, seed=200)]
        tickets = [fe.submit(side.HostCSR.from_dense(d)) for d in dense]
        flags = [fe.pressure]
        fe.pump(1)
        flags.append(fe.pressure)
        fe.pump()
        flags.append(fe.pressure)
        obs = _result(side, fe, tickets, [d @ d for d in dense])
        obs[0]["pressure"] = flags
        return obs
    hot = block_diag_pattern(side, 0 if case == "graduate" else 1)
    extra["hint"] = _warm(side, fe, clock, hot)
    hot_dense = hot.to_dense()
    if case == "graduate":
        first_dense = int_dense(96, seed=7)
        first = side.HostCSR.from_dense(first_dense)
    else:
        first_dense, first = hot_dense, hot
    fill = [int_dense(64, seed=100 + i) for i in range(3)]
    tickets = [fe.submit(first)]
    tickets += [fe.submit(side.HostCSR.from_dense(d)) for d in fill]
    extra["pressure_on"] = fe.pressure
    fe.pump(1)
    fe.pump()
    extra["pressure_after"] = fe.pressure
    oracles = [first_dense @ first_dense] + [d @ d for d in fill]
    if case == "graduate":
        again = side.HostCSR(first.indptr, first.indices,
                             first.data.copy(), first.shape)
        tickets.append(fe.submit(again))
        oracles.append(first_dense @ first_dense)
        fe.pump()
    obs = _result(side, fe, tickets, oracles)
    obs[0].update(extra)
    return obs


@pytest.mark.parametrize("case", ("graduate", "hot", "hysteresis"))
def test_watermark_pressure_like_the_jax_package(case):
    obs = agree(_pressure, case)
    t = obs["tickets"]
    if case == "hysteresis":
        assert obs["pressure"] == [True, True, False]
        return
    assert obs["hint"] >= 50
    assert obs["pressure_on"] and not obs["pressure_after"]
    if case == "graduate":
        # cold under pressure: the identity rung; the same pattern once
        # pressure cleared: a full plan
        assert t[0]["downgraded"] and t[0]["scheme"] == "rowwise"
        assert not t[-1]["downgraded"]
    else:
        assert not t[0]["downgraded"] and t[0]["scheme"] != "rowwise"


# ---------------------------------------------------------------------------
# live reuse estimation and the scheduled recalibration
# ---------------------------------------------------------------------------


def test_estimator_rate_and_hint_dynamics_match_the_jax_package():
    hints = {}
    for side in SIDES:
        clock = FakeClock()
        est = side.ReuseEstimator(clock=clock, tau_s=30.0, horizon_s=60.0)
        trace = [est.reuse_hint("unseen")]
        for _ in range(30):
            est.observe("fp")
            clock.advance(1.0)
            trace.append((est.rate("fp"), est.reuse_hint("fp"),
                          est.is_hot("fp")))
        clock.advance(300.0)
        trace.append(est.reuse_hint("fp"))
        trace.append(est.snapshot())
        hints[side.name] = trace
    assert hints["port"] == hints["ref"]
    assert hints["port"][-3][1] >= 30 and hints["port"][-2] == 1


def _estimator_hint(side):
    fe = frontend(side, FakeClock(), capacity=4)
    seen = []
    plan_orig = fe.server.planner.plan

    def spy(a, reuse_hint=None, **kw):
        plan = plan_orig(a, reuse_hint, **kw)
        seen.append(plan.reuse_hint)
        return plan

    fe.server.planner.plan = spy
    dense = int_dense(64, seed=5)
    a = side.HostCSR.from_dense(dense)
    tickets = [fe.submit(a)]
    fe.pump()
    obs = _result(side, fe, tickets, [dense @ dense])
    obs[0].update(seen=seen,
                  estimate=fe.estimator.reuse_hint(fe._fingerprint(a)),
                  default=fe.server.default_reuse_hint)
    return obs


def _graduation(side):
    clock = FakeClock()
    est = side.ReuseEstimator(clock=clock, horizon_s=30.0, tau_s=30.0)
    fe = frontend(side, clock, capacity=8, estimator=est)
    a = block_diag_pattern(side, 2)
    dense = a.to_dense()
    tickets = [fe.submit(a)]
    fe.pump()
    for _ in range(80):                              # steady 1/s traffic
        clock.advance(1.0)
        tickets.append(fe.submit(side.HostCSR(a.indptr, a.indices,
                                              a.data.copy(), a.shape)))
        fe.pump()
    obs = _result(side, fe, [tickets[0], tickets[-1]], [dense @ dense] * 2)
    obs[0]["schemes"] = [t.result(0).scheme for t in tickets]
    return obs


def test_estimator_hint_replaces_the_default_like_the_jax_package():
    obs = agree(_estimator_hint)
    # one arrival: rate 1/tau over a 2·tau horizon = 2, not the server's
    # static default of 20
    assert obs["seen"] == [obs["estimate"]] == [2]
    assert obs["default"] == 20


def test_hot_pattern_graduates_like_the_jax_package():
    obs = agree(_graduation)
    assert obs["tickets"][0]["scheme"] == "rowwise"
    assert obs["tickets"][1]["scheme"] != "rowwise"


def _recalibrate(side):
    fe = frontend(side, FakeClock(), capacity=4, recalibrate_every=2)
    dense = [int_dense(64, seed=20 + i) for i in range(2)]
    tickets = []
    for d in dense:
        tickets.append(fe.submit(side.HostCSR.from_dense(d)))
        fe.pump()
    obs = _result(side, fe, tickets, [d @ d for d in dense])
    obs[0]["again"] = fe.recalibrate()
    return obs


def test_scheduled_recalibration_skips_under_eight_samples():
    obs = agree(_recalibrate)
    assert obs["counters"]["serve_recalibrations{outcome=skipped}"] == 1
    assert obs["again"] is False


def _samples():
    """Audit-format rows on suite specs and served fingerprints."""
    rng = np.random.default_rng(0)
    rows = []
    for spec in ("mesh2d_24", "blkdiag_1024_8", "road_32"):
        for reorder, scheme in (("original", "rowwise"), ("rcm", "fixed"),
                                ("original", "fixed"), ("gray", "variable"),
                                ("original", "hierarchical")):
            rows.append({"spec": spec, "reorder": reorder,
                         "scheme": scheme,
                         "kernel_rel": float(rng.uniform(0.3, 1.5)),
                         "preprocess_rel": float(rng.uniform(0.0, 3.0))})
    rows += [{"spec": f"serve:{i}", "reorder": "original",
              "scheme": "pallas", "kernel_rel": 1.0,
              "preprocess_rel": 0.4} for i in range(4)]
    return rows


def test_fit_calibration_from_samples_matches_the_jax_package(monkeypatch,
                                                              tmp_path):
    rows = _samples()
    want = ref_calibration.fit_calibration(samples=rows)
    got = port_calibration.fit_calibration(samples=rows)
    assert got.describe() == want.describe()
    assert got.kernel_scale and got.preprocess_scheme
    assert port_calibration.fit_calibration(samples=rows[:7]) is None
    # without samples the port reads its own sweep cache (none here), and
    # the JAX package's trajectory artifacts are never read
    from repro_torch import benchlib
    monkeypatch.setattr(benchlib, "CACHE_PATH",
                        str(tmp_path / "bench_cache_torch.json"))
    assert port_calibration.fit_calibration() is None
    assert port_calibration.fit_calibration(
        artifacts_dir="experiments", samples=rows).describe() \
        == got.describe()
    # the fit, installed, moves the port's scores as it moves the JAX
    # package's (the kernel tier's CPU penalty never rescaled)
    ref_f = ref_features(REF.gen_block_diag(256, block=8, seed=0))
    port_f = port_features(PORT.gen_block_diag(256, block=8, seed=0))
    ref_model = ref_cost.CostModel(calibration=want)
    port_model = port_cost.CostModel(device="cpu", calibration=got)
    for cand in port_cost.DEFAULT_CANDIDATES:
        r = ref_model.score(ref_f, ref_cost.Candidate(cand.reorder,
                                                      cand.scheme), 20)
        p = port_model.score(port_f, cand, 20)
        assert (p.kernel_rel, p.preprocess_rel) == pytest.approx(
            (r.kernel_rel, r.preprocess_rel), rel=1e-12)
    planner = Planner(device="cpu", calibration=got)
    assert planner.cost_model.calibration is got


# ---------------------------------------------------------------------------
# a burst under injected faults
# ---------------------------------------------------------------------------


def _chaos(side, seed):
    dense = [int_dense(64, seed=30 + i) for i in range(3)]
    mats = [side.HostCSR.from_dense(d) for d in dense]
    cache = side.PlanCache()
    for m in mats:
        cache.put(side.Plan(fingerprint=side.fingerprint(m),
                            reorder="original", scheme="pallas",
                            reuse_hint=20))
    side.faults.arm(side.faults.FaultPlan(
        seed, sites=("pack", "kernel_launch", "output"), rate=0.3,
        max_fires=2))
    try:
        fe = frontend(side, FakeClock(), capacity=16, cache=cache)
        tickets = [fe.submit(m, reuse_hint=20) for m in mats
                   for _ in range(2)]
        fe.pump()
    finally:
        side.faults.disarm()
    return _result(side, fe, tickets, [d @ d for d in dense
                                       for _ in range(2)])


@pytest.mark.parametrize("seed", SEEDS)
def test_burst_under_faults_like_the_jax_package(seed):
    obs = agree(_chaos, seed)
    assert all("error" not in t for t in obs["tickets"])


# ---------------------------------------------------------------------------
# worker threads
# ---------------------------------------------------------------------------


@pytest.fixture
def short_switch_interval():
    """Thread switches every microsecond: races show within a test."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("batching", (False, True),
                         ids=("unbatched", "batched"))
def test_threaded_burst_every_ticket_exact(batching, short_switch_interval):
    """64 distinct members through four workers sharing one planner, whose
    exec cache keeps about one entry (every request evicts): every ticket
    resolves, equal to the dense product, and nothing degrades."""
    policy = ResiliencePolicy()
    planner = Planner(cache=PlanCache(), device="cpu",
                      auditor=DriftAuditor(), resilience=policy)
    planner._exec_cache_bytes_cap = 4096
    dense = [int_dense(16 + 16 * (i % 4), density=0.1, seed=1000 + i)
             for i in range(64)]
    fe = AsyncSpGEMMServer(SpGEMMServer(planner), workers=4, capacity=128,
                           batch_policy=BatchPolicy(enabled=batching))
    try:
        tickets = [fe.submit(PORT.HostCSR.from_dense(d), reuse_hint=1)
                   for d in dense]
        for t, d in zip(tickets, dense):
            resp = t.result(120)
            assert np.array_equal(resp.result, d @ d)
            assert not resp.degraded
    finally:
        fe.close()
    assert all(not t.is_alive() for t in fe._threads)
    assert list(policy.incidents) == []
    assert planner.stats["exec_bytes"] <= 4096
    assert fe.stats()["batching"]["served"] == 64
    if batching:
        assert fe.stats()["batching"]["batches"] >= 1


def _hammer(fn, threads=8, iters=400):
    """``fn(thread, i)`` from ``threads`` threads at once; the errors."""
    errors = []
    start = threading.Barrier(threads)

    def work(k):
        start.wait()
        try:
            for i in range(iters):
                fn(k, i)
        except Exception as e:           # noqa: BLE001 — the assertion
            errors.append(repr(e))

    pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(60)
    assert not any(t.is_alive() for t in pool)
    return errors


def _exec_cache_case():
    import torch
    planner = Planner(cache=PlanCache(), device="cpu",
                      auditor=DriftAuditor())
    planner._exec_cache_bytes_cap = 16 * 64 * 4

    def step(k, i):
        planner._exec_put(f"{k}-{i}", ("row", torch.zeros(16)))
        planner._note_pack()
        planner.stats
    return step, lambda: planner.stats["exec_bytes"] <= 16 * 64 * 4


def _plan_cache_case():
    cache = PlanCache(max_bytes=512 * 40)

    def step(k, i):
        fp = str((k * 7 + i) % 97)
        if cache.get(fp, 1) is None:
            cache.put(Plan(fingerprint=fp, reorder="original",
                           scheme="rowwise", reuse_hint=1))
        cache.stats
    return step, lambda: (cache.stats["hits"] + cache.stats["misses"]
                          == 8 * 400 and cache.total_bytes <= 512 * 40)


def _auditor_case():
    auditor = DriftAuditor()

    def step(k, i):
        auditor.record(Plan(fingerprint=f"{k}-{i % 50}", reorder="original",
                            scheme="rowwise", reuse_hint=1),
                       1e-3 * (1 + i % 7))
        if i % 20 == 0:
            auditor.summary()
            auditor.samples()
    return step, lambda: len(auditor.samples()) == 8 * 400


SHARED = {"exec_cache": _exec_cache_case, "plan_cache": _plan_cache_case,
          "drift_auditor": _auditor_case}


@pytest.mark.parametrize("state", sorted(SHARED))
def test_planner_shared_state_survives_threads(state, short_switch_interval):
    step, consistent = SHARED[state]()
    assert _hammer(step) == []
    assert consistent()


def test_default_front_end_runs_on_the_card():
    """Without an inner server the front-end builds ``SpGEMMServer()`` on
    the card: without one it raises, with no fallback to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncSpGEMMServer(workers=0)
    fe = AsyncSpGEMMServer(SpGEMMServer(device="cpu"), workers=0)
    assert fe.server.planner.device.type == "cpu"
    assert counters(PORT) == {}
