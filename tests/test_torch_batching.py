"""The port's cross-request batching against the JAX package's, scenario
for scenario.

The scenarios of ``tests/test_batching.py`` run through both packages'
``AsyncSpGEMMServer`` — the JAX package's and the port's on the CPU —
with ``workers=0`` (the caller pumps) and a fake clock, each package with
its own metrics registry, resilience policy, fault harness and plan
cache. Pallas plans are seeded in both for every pack (under
``workload="batch"``, keyed by the pack's fingerprint in FIFO order) and
for every member, so the batched launch runs the kernel tier: the JAX
package's Pallas kernels in interpret mode, the port's plain versions of
its window kernel. Per ticket the two must agree on the result (integer
values: exact, and equal to the dense product), on ``batched``,
``batch_size``, ``coalesced``, ``downgraded``, ``deadline_missed``,
``degraded``, the scheme, and on ``stats()["batching"]``, the serving
counters and the resilience policy's counters and incidents.

Also: ``block_diag_csr`` against its loop reference and the JAX
package's pack; the eligibility gates and the break-even rule.
"""
import dataclasses
import types

import numpy as np
import pytest

import repro.core.formats as ref_formats
import repro.core.suite as ref_suite
import repro.obs.audit as ref_audit
import repro.obs.metrics as ref_metrics
import repro.planner.cost_model as ref_cost
import repro.planner.features as ref_features
import repro.planner.plan_cache as ref_cache
import repro.planner.service as ref_service
import repro.resilience as ref_resilience
import repro.serve.batcher as ref_batcher
import repro.serve.engine as ref_engine
import repro.serve.estimator as ref_estimator
import repro.serve.frontend as ref_frontend
import repro.serve.queue as ref_queue
import repro_torch.core.formats as port_formats
import repro_torch.core.suite as port_suite
import repro_torch.obs.audit as port_audit
import repro_torch.obs.metrics as port_metrics
import repro_torch.planner.cost_model as port_cost
import repro_torch.planner.features as port_features
import repro_torch.planner.plan_cache as port_cache
import repro_torch.planner.service as port_service
import repro_torch.resilience as port_resilience
import repro_torch.serve.batcher as port_batcher
import repro_torch.serve.engine as port_engine
import repro_torch.serve.estimator as port_estimator
import repro_torch.serve.frontend as port_frontend
import repro_torch.serve.queue as port_queue

SEEDS = (0, 1, 2)


def _side(name, formats, suite, audit, metrics, cost, features, cache,
          service, resilience, batcher, engine, estimator, frontend, queue,
          **planner_kw):
    """One package's serving surface, under one set of names."""
    return types.SimpleNamespace(
        name=name, HostCSR=formats.HostCSR,
        block_diag_csr=formats.block_diag_csr,
        block_diag_csr_reference=formats.block_diag_csr_reference,
        split_block_diag=formats.split_block_diag,
        gen_block_diag=suite.gen_block_diag,
        auditor=audit.get_auditor,
        registry=metrics.get_registry,
        batch_break_even=cost.batch_break_even,
        fingerprint=features.fingerprint, Plan=cache.Plan,
        PlanCache=cache.PlanCache,
        Planner=lambda **kw: service.Planner(**planner_kw, **kw),
        resilience=resilience, faults=resilience.faults,
        BatchPolicy=batcher.BatchPolicy, batchable=batcher.batchable,
        compatible=batcher.compatible, SpGEMMServer=engine.SpGEMMServer,
        ReuseEstimator=estimator.ReuseEstimator,
        AsyncSpGEMMServer=frontend.AsyncSpGEMMServer,
        BoundedRequestQueue=queue.BoundedRequestQueue,
        QueuedRequest=queue.QueuedRequest)


REF = _side("ref", ref_formats, ref_suite, ref_audit, ref_metrics, ref_cost,
            ref_features, ref_cache, ref_service, ref_resilience,
            ref_batcher, ref_engine, ref_estimator, ref_frontend, ref_queue)
PORT = _side("port", port_formats, port_suite, port_audit, port_metrics,
             port_cost, port_features, port_cache, port_service,
             port_resilience, port_batcher, port_engine, port_estimator,
             port_frontend, port_queue, device="cpu")
SIDES = (REF, PORT)


def _reset():
    for side in SIDES:
        side.resilience.reset_policy()
        side.faults.disarm()
        side.registry().reset()
        side.auditor().reset()


@pytest.fixture(autouse=True)
def _fresh_state():
    """Both packages: a fresh global policy, metrics and auditor, and no
    armed fault plan."""
    _reset()
    yield
    _reset()


class FakeClock:
    """Manually advanced monotonic time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def int_dense(n, m=None, density=0.08, seed=0):
    """Integer values in {1, 2, 3}: fp32 sums are exact in any order."""
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.integers(1, 4, (n, m))).astype(np.float32)


def frontend(side, clock, **kw):
    """The package's front-end over an in-memory planner (the JAX test
    suite's ``_frontend``): ``workers=0`` and the fake clock."""
    kw.setdefault("capacity", 16)
    kw.setdefault("workers", 0)
    est = kw.pop("estimator", None) or side.ReuseEstimator(clock=clock)
    cache = kw.pop("cache", None) or side.PlanCache()
    srv = kw.pop("server", None)
    if srv is None:
        srv = side.SpGEMMServer(planner=side.Planner(cache=cache))
    return side.AsyncSpGEMMServer(srv, clock=clock, estimator=est, **kw)


def seed_pallas(side, cache, groups, *, pairs=False, hint=20):
    """Pallas plans for each group's pack (``workload="batch"``, the
    fingerprint of the block-diagonal A in FIFO order) and for each
    member's own request."""
    for group in groups:
        a_list = [g[0] if pairs else g for g in group]
        pack = side.block_diag_csr(a_list)
        cache.put(side.Plan(fingerprint=side.fingerprint(pack.host),
                            reorder="original", scheme="pallas",
                            reuse_hint=hint, workload="batch"))
        for a in a_list:
            cache.put(side.Plan(fingerprint=side.fingerprint(a),
                                reorder="original", scheme="pallas",
                                reuse_hint=hint))
    return cache


FIELDS = ("batched", "batch_size", "coalesced", "downgraded",
          "deadline_missed", "degraded", "fallback_scheme", "scheme",
          "reorder")
COUNTED = ("serve_batches", "batch_occupancy", "batch_launch_amortization",
           "serve_shed", "serve_deadline_miss", "serve_coalesced",
           "serve_downgrades", "serve_recalibrations", "serve_fallbacks",
           "serve_rejects", "serve_requests", "serve_queue_depth",
           "faults_injected", "plan_cache_hits", "plan_cache_misses")


def outcome(ticket):
    """A resolved ticket as (observations, result): the response's
    fields, or the structured error's type and stage/reason."""
    assert ticket.done(), "ticket lost"
    err = ticket.error()
    if err is not None:
        return ({"error": type(err).__name__,
                 "stage": getattr(err, "stage", None),
                 "reason": getattr(err, "reason", None)}, None)
    resp = ticket.result(0)
    return ({f: getattr(resp, f) for f in FIELDS},
            np.asarray(resp.result))


def counters(side) -> dict:
    """The serving counters and gauges of the package's registry
    (histograms by count and max: their sums are timings)."""
    out = {}
    for key, val in side.registry().snapshot().items():
        if key.split("{")[0] not in COUNTED:
            continue
        out[key] = ({k: val.get(k) for k in ("count", "max")}
                    if isinstance(val, dict) else val)
    return out


def accounting(side, fe) -> dict:
    policy = fe.server.planner.resilience
    return {"batching": fe.stats()["batching"],
            "counters": counters(side),
            "policy": {k: v for k, v in policy.stats.items()
                       if k != "breaker"},
            "incidents": [(i.scheme, i.site, i.fallback, i.workload)
                          for i in policy.incidents]}


def agree(scenario, *args):
    """Run ``scenario(side, *args) -> (observations, results, oracles)``
    on both packages: equal observations, equal results, and each result
    equal to its oracle where one is given."""
    ref, port = (scenario(side, *args) for side in SIDES)
    assert port[0] == ref[0]
    assert len(port[1]) == len(ref[1]) == len(port[2])
    for got, want, oracle in zip(port[1], ref[1], port[2]):
        if want is None:
            assert got is None
            continue
        assert np.array_equal(got, want)
        if oracle is not None:
            assert np.array_equal(got, oracle)
    return port[0]


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------


def named_batches():
    """The JAX suite's named batch shapes (square, A² eligible), dense."""
    hub = np.zeros((24, 24), np.float32)
    hub[0, :] = 3.0                  # one dense hub row
    hub[:, 5] = 2.0                  # and a hub column
    hub[3, 3] = 1.0
    empty_rows = np.zeros((16, 16), np.float32)
    empty_rows[2, 7] = 2.0
    empty_rows[9, 1] = 3.0
    return {
        "ragged": [int_dense(n, seed=40 + i)
                   for i, n in enumerate((16, 40, 8, 64))],
        "empty_row": [empty_rows, int_dense(16, seed=45),
                      np.zeros((8, 8), np.float32)],
        "hub": [hub, int_dense(24, seed=46),
                int_dense(12, density=0.3, seed=47)],
        "single_member": [int_dense(32, seed=48)],
        "max_size": [int_dense(16, seed=50 + i) for i in range(8)],
    }


def _random_members(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 7))):
        nr, nc = int(rng.integers(1, 24)), int(rng.integers(1, 24))
        out.append(((rng.random((nr, nc)) < rng.uniform(0.0, 0.5))
                    * rng.integers(1, 4, (nr, nc))).astype(np.float32))
    return out


PACK_CASES = {**{f"named-{k}": v for k, v in named_batches().items()},
              **{f"random-{s}": _random_members(s) for s in range(6)}}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_block_diag_equals_loop_reference_and_the_jax_pack(case):
    dense = PACK_CASES[case]
    packs = {}
    for side in SIDES:
        mats = [side.HostCSR.from_dense(d) for d in dense]
        pack = side.block_diag_csr(mats)
        ref = side.block_diag_csr_reference(mats)
        for got, want in ((pack.host.indptr, ref.host.indptr),
                          (pack.host.indices, ref.host.indices),
                          (pack.host.data, ref.host.data),
                          (pack.row_offsets, ref.row_offsets),
                          (pack.col_offsets, ref.col_offsets)):
            assert np.array_equal(got, want)
        assert pack.host.shape == ref.host.shape
        assert pack.members == len(dense)
        # the pack's dense form splits back into the members
        parts = side.split_block_diag(pack.host.to_dense(), pack)
        assert all(np.array_equal(p, d) for p, d in zip(parts, dense))
        packs[side.name] = pack
    ref, port = packs["ref"], packs["port"]
    for field in ("indptr", "indices", "data"):
        got, want = getattr(port.host, field), getattr(ref.host, field)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(port.row_offsets, ref.row_offsets)
    assert np.array_equal(port.col_offsets, ref.col_offsets)


def test_block_diag_rejects_an_empty_group():
    for fn in (PORT.block_diag_csr, PORT.block_diag_csr_reference):
        with pytest.raises(ValueError):
            fn([])


# ---------------------------------------------------------------------------
# served bursts: per-ticket parity with the JAX package
# ---------------------------------------------------------------------------


def _burst(side, dense, batching, groups):
    """Submit ``dense`` members (reuse 20, capacity well above the burst,
    so watermark pressure never arms) and pump once."""
    mats = [side.HostCSR.from_dense(d) for d in dense]
    cache = seed_pallas(side, side.PlanCache(),
                        [[mats[i] for i in g] for g in groups])
    kw = {} if batching else {"batch_policy": side.BatchPolicy(
        enabled=False)}
    fe = frontend(side, FakeClock(), capacity=64, cache=cache, **kw)
    tickets = [fe.submit(m, reuse_hint=20) for m in mats]
    retired = fe.pump()
    obs = [outcome(t) for t in tickets]
    return ({"retired": retired, "tickets": [o for o, _ in obs],
             **accounting(side, fe)},
            [r for _, r in obs], [d @ d for d in dense])


@pytest.mark.parametrize("batching", (True, False),
                         ids=("batched", "unbatched"))
@pytest.mark.parametrize("shape", sorted(named_batches()))
def test_named_batch_shapes_served_like_the_jax_package(shape, batching):
    dense = named_batches()[shape]
    obs = agree(_burst, dense, batching, [range(len(dense))])
    tickets = obs["tickets"]
    assert all(t["scheme"] == "pallas" and not t["degraded"]
               for t in tickets)
    if batching and len(dense) >= 2:
        assert all(t["batched"] and t["batch_size"] == len(dense)
                   for t in tickets)
        assert obs["batching"]["launch_amortization"] == len(dense)
        assert obs["counters"]['serve_batches{outcome=served}'] == 1
    else:
        assert not any(t["batched"] for t in tickets)


def test_2x_burst_batches_into_two_full_launches_like_the_jax_package():
    group = PORT.BatchPolicy().max_members
    dense = [int_dense(24, seed=100 + i) for i in range(2 * group)]
    obs = agree(_burst, dense, True,
                [range(group), range(group, 2 * group)])
    assert obs["retired"] == 2 * group
    assert all(t["batched"] and t["batch_size"] == group
               for t in obs["tickets"])
    assert obs["batching"] == {"batches": 2, "batched_members": 2 * group,
                               "launches": 2, "served": 2 * group,
                               "launch_amortization": float(group)}
    assert obs["counters"]["batch_occupancy"] == {"count": 2,
                                                  "max": float(group)}
    assert obs["policy"]["sheds"] == 0 and obs["policy"]["rejects"] == 0


def _float_burst(side, batching, sizes):
    rng = np.random.default_rng(sum(sizes))
    dense = [((rng.random((n, n)) < 0.1)
              * rng.uniform(0.5, 2.0, (n, n))).astype(np.float32)
             for n in sizes]
    return _burst(side, dense, batching, [range(len(dense))])


@pytest.mark.parametrize("sizes", [(16, 40, 8, 64), (64,) * 8,
                                   (200, 56, 130)], ids=str)
def test_float_values_batched_bit_identical_to_unbatched(sizes):
    """Non-integer values: on the port's CPU path a member's sums run in
    ascending k whatever its offsets in the pack, so batched equals
    unbatched bit for bit; the JAX package's batched results (Pallas in
    interpret mode, tile sums) agree within 1e-5 of the largest value."""
    batched = _float_burst(PORT, True, sizes)
    unbatched = _float_burst(PORT, False, sizes)
    ref = _float_burst(REF, True, sizes)
    assert all(t["batched"] for t in batched[0]["tickets"])
    for b, u, r in zip(batched[1], unbatched[1], ref[1]):
        assert np.array_equal(b, u)
        scale = float(np.abs(r).max())
        assert float(np.abs(b - r).max()) <= 1e-5 * scale


def _pairs(side):
    dense = [(int_dense(12, 20, 0.2, 70), int_dense(20, 9, 0.2, 71)),
             (int_dense(30, 6, 0.2, 72), int_dense(6, 14, 0.2, 73)),
             (int_dense(8, 8, 0.2, 74), int_dense(8, 8, 0.2, 75))]
    pairs = [(side.HostCSR.from_dense(a), side.HostCSR.from_dense(b))
             for a, b in dense]
    cache = seed_pallas(side, side.PlanCache(), [pairs], pairs=True)
    fe = frontend(side, FakeClock(), capacity=16, cache=cache)
    tickets = [fe.submit(a, b, reuse_hint=20) for a, b in pairs]
    fe.pump()
    obs = [outcome(t) for t in tickets]
    return ({"tickets": [o for o, _ in obs], **accounting(side, fe)},
            [r for _, r in obs], [a @ b for a, b in dense])


def test_sparse_ab_pairs_batched_like_the_jax_package():
    obs = agree(_pairs)
    assert all(t["batched"] and t["batch_size"] == 3 and
               t["scheme"] == "pallas" for t in obs["tickets"])


def _faulted_batch(side, seed):
    """A kernel_launch fault at rate 1.0, two fires: the first kills the
    batched launch (disband), the second the first member's pallas re-run
    (recovered on the fixed rung)."""
    dense = [int_dense(32, seed=60 + i) for i in range(4)]
    mats = [side.HostCSR.from_dense(d) for d in dense]
    cache = seed_pallas(side, side.PlanCache(), [mats])
    side.faults.arm(side.faults.FaultPlan(seed, sites=("kernel_launch",),
                                          rate=1.0, max_fires=2))
    try:
        fe = frontend(side, FakeClock(), capacity=16, cache=cache)
        tickets = [fe.submit(m, reuse_hint=20) for m in mats]
        fe.pump()
    finally:
        side.faults.disarm()
    obs = [outcome(t) for t in tickets]
    return ({"tickets": [o for o, _ in obs], **accounting(side, fe)},
            [r for _, r in obs], [d @ d for d in dense])


@pytest.mark.parametrize("seed", SEEDS)
def test_faulted_batch_disbands_and_recovers_like_the_jax_package(seed):
    obs = agree(_faulted_batch, seed)
    assert not any(t["batched"] for t in obs["tickets"])
    assert obs["counters"]["serve_batches{outcome=disbanded}"] == 1
    assert "serve_batches{outcome=served}" not in obs["counters"]
    assert [i[2] for i in obs["incidents"]] == ["unbatch", "fixed"]
    assert obs["policy"]["fallbacks"] == 2
    assert obs["counters"]["faults_injected{site=kernel_launch}"] == 2
    assert obs["batching"]["batches"] == 0
    assert obs["batching"]["launches"] == 4


def _expiry(side):
    dense = [int_dense(24, seed=80 + i) for i in range(3)]
    m1, m2, m3 = (side.HostCSR.from_dense(d) for d in dense)
    clock = FakeClock()
    fe = frontend(side, clock, capacity=8,
                  cache=seed_pallas(side, side.PlanCache(), [[m1, m3]]))
    tickets = [fe.submit(m1, reuse_hint=20),
               fe.submit(m2, reuse_hint=20, deadline_s=1.0),
               fe.submit(m3, reuse_hint=20)]
    clock.advance(5.0)               # the middle budget dies in the queue
    fe.pump()
    obs = [outcome(t) for t in tickets]
    return ({"tickets": [o for o, _ in obs], **accounting(side, fe)},
            [r for _, r in obs], [d @ d for d in dense])


def test_expired_ticket_is_swept_before_packing_like_the_jax_package():
    obs = agree(_expiry)
    first, dead, last = obs["tickets"]
    assert dead == {"error": "DeadlineExceededError", "stage": "queue",
                    "reason": None}
    assert first["batched"] and first["batch_size"] == 2
    assert last["batched"] and last["batch_size"] == 2
    assert obs["counters"]["serve_deadline_miss{stage=queue}"] == 1


def test_take_group_sweeps_expired_before_packing():
    for side in SIDES:
        q = side.BoundedRequestQueue(8, tenant_capacity=4)
        live1 = side.QueuedRequest(a=None, tenant="x")
        dead = side.QueuedRequest(a=None, tenant="x", deadline_at=5.0)
        live2 = side.QueuedRequest(a=None, tenant="y")
        for r in (live1, dead, live2):
            q.offer(r)
        group, expired = q.take_group(limit=8, predicate=lambda h, r: True,
                                      now=10.0)
        assert expired == [dead] and group == [live1, live2]
        assert q.depth() == 0 and q.depth_of("x") == q.depth_of("y") == 0


# ---------------------------------------------------------------------------
# eligibility gates and the break-even rule
# ---------------------------------------------------------------------------


def _gate_requests(side):
    m = side.HostCSR.from_dense(int_dense(32, seed=1))
    big = side.HostCSR.from_dense(int_dense(512, density=0.01, seed=2))
    rect = side.HostCSR.from_dense(int_dense(8, 10, 0.2, 3))
    rect_b = side.HostCSR.from_dense(int_dense(10, 6, 0.2, 4))
    q = side.QueuedRequest
    return {"square": q(a=m), "chain": q(a=m, hops=2),
            "downgraded": q(a=m, downgrade=True),
            "dense_b": q(a=m, b=np.ones((32, 4), np.float32)),
            "oversized": q(a=big), "rect_a2": q(a=rect),
            "ab_pair": q(a=rect, b=rect_b)}


def test_batchable_gates_match_the_jax_package():
    verdicts = {}
    for side in SIDES:
        reqs = _gate_requests(side)
        on, off = side.BatchPolicy(), side.BatchPolicy(enabled=False)
        verdicts[side.name] = (
            {k: side.batchable(r, on) for k, r in reqs.items()},
            {k: side.batchable(r, off) for k, r in reqs.items()},
            {(h, k): side.compatible(reqs[h], reqs[k])
             for h in ("square", "ab_pair") for k in reqs})
    assert verdicts["port"] == verdicts["ref"]
    on, off, compat = verdicts["port"]
    assert {k for k, v in on.items() if v} == {"square", "ab_pair"}
    assert not any(off.values())
    assert not compat[("square", "ab_pair")]
    assert compat[("square", "square")]


@pytest.mark.parametrize("members", range(0, 10))
@pytest.mark.parametrize("rates", ((1.0, 0.15), (0.0, 0.15), (0.3, 0.2)),
                         ids=("default", "free_dispatch", "costly_pack"))
def test_batch_break_even_matches_the_jax_package(members, rates):
    dispatch, pack = rates
    got = PORT.batch_break_even(members, dispatch_rel=dispatch,
                                pack_rel=pack)
    assert got == REF.batch_break_even(members, dispatch_rel=dispatch,
                                       pack_rel=pack)
    if rates == (1.0, 0.15):
        assert got == (members >= 2)
        assert PORT.batch_break_even(members) == got


def test_batch_workload_is_planned_apart_and_takes_the_discount(monkeypatch):
    """A pack planned under ``workload="batch"`` caches apart from the
    same pattern's A² plan, and an unmeasured pallas candidate on the card
    takes the sharded discount of its traffic prior on a batch pack as on
    A²."""
    h = PORT.HostCSR.from_dense(int_dense(32, seed=5))
    planner = PORT.Planner(cache=PORT.PlanCache())
    a2 = planner.plan(h, 1)
    batch = planner.plan(h, 1, workload="batch")
    assert batch.workload == "batch" and a2.workload == "a2"
    assert planner.cache.stats["entries"] == 2
    with pytest.raises(ValueError, match="unknown workload"):
        planner.plan(h, 1, workload="bogus")
    model = port_cost.CostModel(device="cuda")
    pallas = port_cost.Candidate("original", "pallas")
    card = port_cost.PALLAS_CARD_SPGEMM_GATHER_BYTES

    def rels(fill):
        # a 32-row pack fills a 128 × 128 tile too thinly for either
        # price to leave a clamp: set fills show the divisor — the
        # features' floor for the sparse-B price (the card's gather
        # cost), a mid-range fill for SpMM's (the JAX package's)
        feats = dataclasses.replace(port_features.extract_features(h),
                                    tile128_fill=fill)
        return {w: model.score(feats, pallas, 20, workload=w).kernel_rel
                for w in ("a2", "batch", "spmm")}

    one, one_mid = rels(1e-4), rels(0.5)
    assert one["batch"] == one["a2"] == (
        (port_cost.PALLAS_B_BYTES_PER_SLOT / 1e-4
         + port_cost.PALLAS_A_BYTES_PER_SLOT
         / (1e-4 * port_cost.PALLAS_SLAB_FILL_BOOST)) / card
        + port_cost.PALLAS_DEAD_STEP_REL)
    assert 0.15 < one["a2"] < port_cost.PALLAS_INTERPRET_REL
    assert one_mid["spmm"] == (
        (port_cost.PALLAS_B_BYTES_PER_SLOT / 0.5
         + port_cost.PALLAS_A_BYTES_PER_SLOT)
        / port_cost.PALLAS_GATHER_BYTES + port_cost.PALLAS_DEAD_STEP_REL)
    assert 0.15 < one_mid["spmm"] < port_cost.PALLAS_INTERPRET_REL
    monkeypatch.setattr(port_cost, "_pallas_core_count", lambda: 4)
    four, four_mid = rels(1e-4), rels(0.5)
    assert four["batch"] == four["a2"] == one["a2"] / 4
    assert four_mid["spmm"] == one_mid["spmm"]


def test_execute_batch_disbands_instead_of_laddering():
    """A failing ``execute_batch`` records the breaker failure and the
    ``unbatch`` incident and re-raises (no rung runs); the next launch
    serves the pack, each diagonal block its member's product."""
    dense = [int_dense(16, seed=90 + i) for i in range(2)]
    for side in SIDES:
        mats = [side.HostCSR.from_dense(d) for d in dense]
        pack = side.block_diag_csr(mats)
        planner = side.Planner(cache=seed_pallas(side, side.PlanCache(),
                                                 [mats]))
        plan = planner.plan(pack.host, 20, workload="batch")
        assert plan.scheme == "pallas" and plan.from_cache
        side.faults.arm(side.faults.FaultPlan(0, sites=("kernel_launch",),
                                              rate=1.0, max_fires=1))
        try:
            with pytest.raises(Exception, match="kernel_launch"):
                planner.execute_batch(plan, pack.host)
        finally:
            side.faults.disarm()
        policy = planner.resilience
        assert [i.fallback for i in policy.incidents] == ["unbatch"]
        assert policy.fallbacks == 1
        out = np.asarray(planner.execute_batch(plan, pack.host))
        for part, d in zip(side.split_block_diag(out, pack), dense):
            assert np.array_equal(part, d @ d)
