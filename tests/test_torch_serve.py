"""The port's serving path against the JAX package's, request for request.

The same request sequences go through ``repro.serve.engine.SpGEMMServer``
and ``repro_torch.serve.engine.SpGEMMServer(device="cpu")``:

* fresh heuristic planners at reuse 1 and 50 pick the same ``scheme``
  and ``reorder`` and return the same result (integer-valued operands:
  exact);
* plans seeded with the ``pallas`` scheme (plain order and RCM) are
  served as ``pallas`` by both, hit the plan cache on repeats and return
  exact results in the original order;
* dense-B (SpMM) requests match;
* malformed operands are rejected with the same
  ``InvalidOperandError.field``.

The port's own rules are pinned too: the cost model's device-keyed
``pallas`` score (the JAX package's on-accelerator traffic prior on a
card), measured mode probing the kernel tier first on a card,
and failures propagating when the resilience policy's ladder is off (the
ladder itself is held against the JAX package in
``tests/test_torch_resilience.py``).
"""
import numpy as np
import pytest
import torch

from repro.core.formats import HostCSR as RefHostCSR
from repro.planner.cost_model import (CostModel as RefCostModel,
                                      DEFAULT_CANDIDATES as REF_CANDIDATES)
from repro.planner.features import extract_features as ref_features
from repro.planner.features import fingerprint as ref_fingerprint
from repro.planner.plan_cache import Plan as RefPlan
from repro.planner.plan_cache import PlanCache as RefPlanCache
from repro.planner.service import Planner as RefPlanner
from repro.planner.service import _materialize as ref_materialize
from repro.resilience import InvalidOperandError as RefInvalid
from repro.resilience import reset_policy
from repro.serve.engine import SpGEMMServer as RefServer
from repro_torch.core.formats import HostCSR
from repro_torch.planner.cost_model import (DEFAULT_CANDIDATES, IDENTITY,
                                            PALLAS_A_BYTES_PER_SLOT,
                                            PALLAS_B_BYTES_PER_SLOT,
                                            PALLAS_DEAD_STEP_REL,
                                            PALLAS_GATHER_BYTES, Candidate,
                                            CostModel)
from repro_torch.planner.features import extract_features, fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner, _materialize
from repro_torch.resilience import ResiliencePolicy, faults
from repro_torch.resilience import reset_policy as reset_port_policy
from repro_torch.resilience.errors import (FaultInjectedError,
                                           InvalidOperandError)
from repro_torch.serve.engine import SpGEMMServer

from torch_port_helpers import family_pair, integer_dense


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_policy()
    reset_port_policy()
    faults.disarm()
    yield
    reset_policy()
    reset_port_policy()
    faults.disarm()


def _pair(dense):
    return RefHostCSR.from_dense(dense), HostCSR.from_dense(dense)


def _revalue(h_ref, h_port, seed):
    data = np.random.default_rng(seed).integers(1, 4, h_ref.nnz).astype(
        np.float32)
    return (RefHostCSR(h_ref.indptr, h_ref.indices, data, h_ref.shape),
            HostCSR(h_port.indptr, h_port.indices, data, h_port.shape))


def _oracle(h, b=None):
    d = h.to_dense()
    return d @ (d if b is None else b)


def _same(r_ref, r_port, want):
    assert r_port.scheme == r_ref.scheme
    assert r_port.reorder == r_ref.reorder
    assert r_port.workload == r_ref.workload
    assert r_port.plan_cache_hit == r_ref.plan_cache_hit
    assert r_port.fingerprint == r_ref.fingerprint
    assert r_port.result.dtype == np.float32
    assert np.array_equal(r_port.result, np.asarray(r_ref.result))
    assert np.array_equal(r_port.result, want)


MATRICES = {
    "rand96": lambda: _pair(integer_dense(96, 96, 0.08, 1)),
    "kron_10_8": lambda: family_pair("kron_10_8"),
    "blkdiag_1024_8": lambda: family_pair("blkdiag_1024_8"),
}


@pytest.mark.parametrize("reuse", [1, 50])
@pytest.mark.parametrize("name", list(MATRICES))
def test_heuristic_planner_serves_like_the_reference(name, reuse):
    h_ref, h_port = MATRICES[name]()
    ref = RefServer(planner=RefPlanner(cache=RefPlanCache()))
    port = SpGEMMServer(device="cpu")
    for seed in (None, 3):
        if seed is not None:
            h_ref, h_port = _revalue(h_ref, h_port, seed)
        r_ref = ref.submit(h_ref, reuse_hint=reuse)
        r_port = port.submit(h_port, reuse_hint=reuse)
        _same(r_ref, r_port, _oracle(h_port))
    assert r_port.plan_cache_hit            # second request: same pattern
    assert port.stats()["plan_hits"] == 1


@pytest.mark.parametrize("reorder", ["original", "rcm"])
def test_seeded_pallas_plan_serves_like_the_reference(reorder):
    h_ref, h_port = _pair(integer_dense(48, 48, 0.12, 5))
    perm_r, bounds_r, mc, _ = ref_materialize(h_ref,
                                              Candidate(reorder, "pallas"))
    perm_p, bounds_p, _, _ = _materialize(h_port, Candidate(reorder,
                                                            "pallas"))
    assert (perm_r is None and perm_p is None) or np.array_equal(perm_r,
                                                                 perm_p)
    ref_cache, port_cache = RefPlanCache(), PlanCache()
    ref_cache.put(RefPlan(fingerprint=ref_fingerprint(h_ref),
                          reorder=reorder, scheme="pallas", reuse_hint=20,
                          max_cluster=mc, perm=perm_r, boundaries=bounds_r))
    port_cache.put(Plan(fingerprint=fingerprint(h_port), reorder=reorder,
                        scheme="pallas", reuse_hint=20, max_cluster=mc,
                        perm=perm_p, boundaries=bounds_p))
    ref = RefServer(planner=RefPlanner(cache=ref_cache))
    port = SpGEMMServer(Planner(cache=port_cache, device="cpu"))
    for seed in (None, 11, 12):
        if seed is not None:
            h_ref, h_port = _revalue(h_ref, h_port, seed)
        r_ref, r_port = ref.submit(h_ref), port.submit(h_port)
        assert r_port.scheme == "pallas" and r_port.plan_cache_hit
        _same(r_ref, r_port, _oracle(h_port))


def test_dense_b_spmm_requests_match():
    h_ref, h_port = _pair(integer_dense(64, 64, 0.1, 21))
    bd = np.random.default_rng(22).integers(-2, 3, (64, 24)).astype(
        np.float32)
    # a seeded pallas SpMM plan, then the heuristic plan of a new pattern
    ref_cache, port_cache = RefPlanCache(), PlanCache()
    ref_cache.put(RefPlan(fingerprint=ref_fingerprint(h_ref),
                          reorder="original", scheme="pallas", reuse_hint=20,
                          workload="spmm"))
    port_cache.put(Plan(fingerprint=fingerprint(h_port), reorder="original",
                        scheme="pallas", reuse_hint=20, workload="spmm"))
    ref = RefServer(planner=RefPlanner(cache=ref_cache))
    port = SpGEMMServer(Planner(cache=port_cache, device="cpu"))
    r_ref, r_port = ref.submit(h_ref, bd), port.submit(h_port, bd)
    assert r_port.scheme == "pallas" and r_port.workload == "spmm"
    _same(r_ref, r_port, h_port.to_dense() @ bd)
    g_ref, g_port = _pair(integer_dense(80, 80, 0.07, 23))
    bd2 = np.random.default_rng(24).integers(-2, 3, (80, 8)).astype(
        np.float32)
    for reuse in (1, 50):
        _same(ref.submit(g_ref, bd2, reuse_hint=reuse),
              port.submit(g_port, bd2, reuse_hint=reuse),
              g_port.to_dense() @ bd2)


def _mutations():
    def nonmonotone(h):
        h.indptr[1], h.indptr[2] = h.indptr[2] + 1, h.indptr[1]

    def bad_start(h):
        h.indptr[0] = 1

    def bad_end(h):
        h.indptr[-1] = h.nnz + 3

    def out_of_range(h):
        h.indices[0] = h.ncols

    def negative(h):
        h.indices[0] = -1

    def unsorted(h):
        row = int(np.argmax(np.diff(h.indptr) >= 2))
        s = h.indptr[row]
        h.indices[s], h.indices[s + 1] = h.indices[s + 1], h.indices[s]

    def nonfinite(h):
        h.data[0] = np.nan

    return [("indptr", nonmonotone), ("indptr", bad_start),
            ("indptr", bad_end), ("indices", out_of_range),
            ("indices", negative), ("indices", unsorted),
            ("data", nonfinite)]


@pytest.mark.parametrize("field,mutate", _mutations(),
                         ids=[m.__name__ for _, m in _mutations()])
def test_malformed_operand_rejected_with_the_same_field(field, mutate):
    dense = integer_dense(32, 32, 0.15, 31)
    h_ref, h_port = _pair(dense)
    for h in (h_ref, h_port):
        mutate(h)
    ref = RefServer(planner=RefPlanner(cache=RefPlanCache()))
    port = SpGEMMServer(device="cpu")
    with pytest.raises(RefInvalid) as e_ref:
        ref.submit(h_ref)
    with pytest.raises(InvalidOperandError) as e_port:
        port.submit(h_port)
    assert e_port.value.field == e_ref.value.field == field


def test_operand_shape_chain_rejected_like_the_reference():
    h_ref, h_port = _pair(integer_dense(32, 32, 0.15, 32))
    ref = RefServer(planner=RefPlanner(cache=RefPlanCache()))
    port = SpGEMMServer(device="cpu")
    bad_b = np.ones((31, 4), np.float32)
    with pytest.raises(RefInvalid) as e_ref:
        ref.submit(h_ref, bad_b)
    with pytest.raises(InvalidOperandError) as e_port:
        port.submit(h_port, bad_b)
    assert e_port.value.field == e_ref.value.field == "shape"


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_cpu_cost_model_scores_like_the_reference():
    h_ref, h_port = family_pair("plaw_1024_10")
    f_ref, f_port = ref_features(h_ref), extract_features(h_port)
    assert f_port.to_dict() == f_ref.to_dict()
    ref, port = RefCostModel(), CostModel(device="cpu")
    assert [c.key for c in DEFAULT_CANDIDATES] == [c.key for c in
                                                   REF_CANDIDATES]
    for reuse in (1, 20, 10000):
        for c in DEFAULT_CANDIDATES:
            r = ref.score(f_ref, c, reuse)
            p = port.score(f_port, c, reuse)
            assert (p.kernel_rel, p.preprocess_rel, p.amortizes) \
                == (r.kernel_rel, r.preprocess_rel, r.amortizes)
        assert port.choose(f_port, reuse).candidate.key \
            == ref.choose(f_ref, reuse).candidate.key


def test_card_cost_model_needs_a_measurement_to_pick_pallas(monkeypatch):
    """On kron_10_8 the card's traffic prior — the JAX package's
    on-accelerator score at one core — ranks the kernel tier far behind
    the gather tier at every reuse count, so only a measurement routes
    the pattern to it."""
    import repro.planner.cost_model as ref_cost
    monkeypatch.setattr(ref_cost, "_pallas_on_tpu", lambda: True)
    monkeypatch.setattr(ref_cost, "_pallas_core_count", lambda: 1)
    h_ref, h = family_pair("kron_10_8")
    f, f_ref = extract_features(h), ref_features(h_ref)
    model, ref = CostModel(device="cuda"), RefCostModel()
    for reuse in (1, 100, 10000):
        assert model.choose(f, reuse).candidate.scheme != "pallas"
        for s in model.rank(f, reuse):
            if s.candidate.scheme == "pallas":
                want = ref.score(f_ref, s.candidate, reuse)
                assert s.kernel_rel == want.kernel_rel > 1.0
                assert not s.amortizes and not want.amortizes
    fp = fingerprint(h)
    model.observe(fp, IDENTITY, kernel_s=1.0, preprocess_s=0.0)
    model.observe(fp, Candidate("original", "pallas"), kernel_s=0.2,
                  preprocess_s=0.1)
    assert model.choose(f, 20, fingerprint=fp).candidate.key \
        == "original+pallas"


def test_card_prior_on_a_dense_pattern_amortizes_but_ranks_behind(
        monkeypatch):
    """On a 90%-full pattern the prior sits near its one-shard floor
    ((4 + 4) / 10.4 + 0.01 B-traffic ratio, fill 1): the kernel tier
    amortizes at the server's reuse of 20, yet the clustered gather
    schemes rank ahead of it — the cold plan is the JAX package's
    on-accelerator plan, and not the kernels."""
    import repro.planner.cost_model as ref_cost
    monkeypatch.setattr(ref_cost, "_pallas_on_tpu", lambda: True)
    monkeypatch.setattr(ref_cost, "_pallas_core_count", lambda: 1)
    h_ref, h = _pair(integer_dense(128, 128, 0.9, 7))
    f, f_ref = extract_features(h), ref_features(h_ref)
    model, ref = CostModel(device="cuda"), RefCostModel()
    floor = ((PALLAS_B_BYTES_PER_SLOT + PALLAS_A_BYTES_PER_SLOT)
             / PALLAS_GATHER_BYTES + PALLAS_DEAD_STEP_REL)
    for s in model.rank(f, 20):
        if s.candidate.scheme == "pallas":
            assert floor <= s.kernel_rel < 0.97 and s.amortizes
    best = model.choose(f, 20)
    assert best.candidate.scheme != "pallas"
    assert best.candidate.key == ref.choose(f_ref, 20).candidate.key
    planner = Planner(device="cpu")
    planner.device = torch.device("cuda")    # plans key on the device
    planner.cost_model = model
    plan = planner.plan(h, 20)
    assert (plan.reorder, plan.scheme) == (best.candidate.reorder,
                                           best.candidate.scheme)


def test_card_planner_probes_the_kernel_tier_first():
    """The prior ranks both kernel-tier candidates last on kron_10_8 (they
    do not amortize); measured mode on the card still probes them first,
    right after the identity baseline, because the prior overprices the
    card's kernels. On the CPU they are never probed."""
    _, h = family_pair("kron_10_8")
    planner = Planner(device="cpu")
    ranked_cpu = planner.cost_model.rank(extract_features(h), 20)
    assert all(s.candidate.scheme != "pallas"
               for s in planner._shortlist(ranked_cpu))
    planner.device = torch.device("cuda")      # the rule keys on the device
    ranked = CostModel(device="cuda").rank(extract_features(h), 20)
    assert [s.candidate.scheme for s in ranked[-2:]] == ["pallas", "pallas"]
    assert not any(s.amortizes for s in ranked[-2:])
    short = planner._shortlist(ranked)
    assert short[0].candidate == IDENTITY
    assert [s.candidate.scheme for s in short[1:3]] == ["pallas", "pallas"]
    assert sum(s.preprocess_rel for s in short) <= planner.measure_budget


def test_measured_mode_serves_on_cpu():
    _, h = _pair(integer_dense(64, 64, 0.1, 41))
    server = SpGEMMServer(device="cpu", measure=True)
    resp = server.submit(h)
    assert np.array_equal(resp.result, _oracle(h))
    plan = server.planner.cache.get(resp.fingerprint, 20)
    assert plan is not None and plan.measured


def test_failures_propagate_without_a_ladder():
    _, h = _pair(integer_dense(48, 48, 0.12, 51))
    cache = PlanCache()
    cache.put(Plan(fingerprint=fingerprint(h), reorder="original",
                   scheme="pallas", reuse_hint=20))
    server = SpGEMMServer(Planner(cache=cache, device="cpu",
                                  resilience=ResiliencePolicy(ladder=False)))
    with faults.injected(faults.FaultPlan(0, sites=["kernel_launch"])):
        with pytest.raises(FaultInjectedError):
            server.submit(h)
    server.planner._exec_cache.clear()
    with faults.injected(faults.FaultPlan(0, sites=["pack"])):
        with pytest.raises(FaultInjectedError):
            server.submit(h)
    resp = server.submit(h)
    assert np.array_equal(resp.result, _oracle(h))
    assert resp.scheme == "pallas" and not resp.degraded


def test_plan_cache_disk_round_trip(tmp_path):
    _, h = _pair(integer_dense(64, 64, 0.1, 61))
    planner = Planner(cache=PlanCache(path=str(tmp_path)), device="cpu")
    plan = planner.plan(h, 50)
    fresh = PlanCache(path=str(tmp_path))
    hit = fresh.get(plan.fingerprint, 50)
    assert hit is not None and hit.from_cache
    assert (hit.scheme, hit.reorder) == (plan.scheme, plan.reorder)
    out = Planner(cache=fresh, device="cpu").execute(hit, h)
    assert np.array_equal(out, _oracle(h))


@pytest.mark.parametrize("workload", ["a2", "spmm"])
def test_exec_cache_keeps_launch_operands_within_its_byte_cap(workload):
    """Fresh-valued traffic packs anew and adds an exec-cache entry per
    request. An entry keeps only what the launch reads (no padded BCC),
    the cache stays within its byte cap by evicting the oldest entries,
    a repeat of the last values still hits, and an entry larger than the
    cap is served but not kept."""
    from repro_torch.core.formats import BCC
    from repro_torch.obs import metrics as obs_metrics
    _, h = _pair(integer_dense(96, 96, 0.08, 71))
    bd = (np.random.default_rng(72).integers(-2, 3, (96, 12)).astype(
        np.float32) if workload == "spmm" else None)

    def revalued(seed):
        return HostCSR(h.indptr, h.indices, np.random.default_rng(
            seed).integers(1, 4, h.nnz).astype(np.float32), h.shape)

    def server(cap=None):
        cache = PlanCache()
        cache.put(Plan(fingerprint=fingerprint(h), reorder="original",
                       scheme="pallas", reuse_hint=20, workload=workload))
        planner = Planner(cache=cache, device="cpu")
        if cap is not None:
            planner._exec_cache_bytes_cap = cap
        return SpGEMMServer(planner)

    probe = server()
    probe.submit(h, bd)
    ((packed, one),) = probe.planner._exec_cache.values()
    assert packed[0] == ("pallas" if workload == "a2" else "spmm_pallas")
    assert not any(isinstance(x, BCC) for x in packed)
    assert one > 0

    srv = server(cap=int(2.5 * one))
    packs = obs_metrics.get_registry().counter("exec_cache_packs")
    for seed in range(6):
        hv = revalued(seed)
        resp = srv.submit(hv, bd)
        assert resp.scheme == "pallas" and resp.plan_cache_hit
        assert np.array_equal(resp.result, _oracle(hv, bd))
        stats = srv.planner.stats
        assert stats["exec_bytes"] <= int(2.5 * one)
        assert stats["exec_entries"] == min(seed + 1, 2)
    before = packs.value
    assert np.array_equal(srv.submit(hv, bd).result, _oracle(hv, bd))
    assert packs.value == before                 # exec-cache hit

    tight = server(cap=one - 1)
    assert np.array_equal(tight.submit(h, bd).result, _oracle(h, bd))
    assert tight.planner.stats["exec_entries"] == 0
