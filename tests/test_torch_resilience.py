"""The port's degradation ladder and circuit breaker against the JAX
package's, scenario for scenario.

The scenarios of ``tests/test_resilience.py`` run through both
``SpGEMMServer``s — the JAX package's and the port's on the CPU — under
fault seeds 0, 1 and 2 (the seeds ``make test-chaos`` runs the JAX
package's suite under through ``CHAOS_SEED``), each package with its own
fault harness, policy and plan cache. The two must agree on ``degraded``,
``fallback_scheme``, the recorded incidents (every field but the time),
the policy's counters and the results (integer-valued operands: exact).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.formats import HostCSR as RefHostCSR
from repro.planner.features import fingerprint as ref_fingerprint
from repro.planner.plan_cache import Plan as RefPlan
from repro.planner.plan_cache import PlanCache as RefPlanCache
from repro.planner.service import Planner as RefPlanner
from repro.resilience import CircuitBreaker as RefBreaker
from repro.resilience import LadderExhaustedError as RefExhausted
from repro.resilience import ResiliencePolicy as RefPolicy
from repro.resilience import faults as ref_faults
from repro.resilience import get_policy as ref_policy
from repro.resilience import reset_policy as ref_reset
from repro.resilience import set_policy as ref_set
from repro.serve.engine import SpGEMMServer as RefServer
from repro_torch.core.formats import HostCSR
from repro_torch.obs import metrics as obs_metrics
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner
from repro_torch.resilience import (CircuitBreaker, LadderExhaustedError,
                                    ResiliencePolicy, faults, get_policy,
                                    reset_policy, set_policy)
from repro_torch.resilience.errors import (FaultInjectedError,
                                           NonFiniteOutputError)
from repro_torch.serve.engine import SpGEMMServer

SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True)
def _fresh_state():
    for reset in (ref_reset, reset_policy, ref_faults.disarm,
                  faults.disarm):
        reset()
    yield
    for reset in (ref_reset, reset_policy, ref_faults.disarm,
                  faults.disarm):
        reset()


def _mats(n=64, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n, n)) < density)
             * rng.integers(1, 4, (n, n))).astype(np.float32)
    return RefHostCSR.from_dense(dense), HostCSR.from_dense(dense), dense


class Pair:
    """The same scenario on both packages: a pallas plan seeded for the
    matrix, one server each."""

    def __init__(self, seed, *, ref_cache=None, port_cache=None,
                 reuse_hint=20):
        self.ref_a, self.a, dense = _mats(seed=seed)
        self.oracle = dense @ dense
        self.ref_cache = ref_cache if ref_cache is not None \
            else RefPlanCache()
        self.port_cache = port_cache if port_cache is not None \
            else PlanCache()
        self.ref_cache.put(RefPlan(fingerprint=ref_fingerprint(self.ref_a),
                                   reorder="original", scheme="pallas",
                                   reuse_hint=reuse_hint))
        self.port_cache.put(Plan(fingerprint=fingerprint(self.a),
                                 reorder="original", scheme="pallas",
                                 reuse_hint=reuse_hint))
        self.ref = RefServer(planner=RefPlanner(cache=self.ref_cache),
                             default_reuse_hint=reuse_hint)
        self.port = SpGEMMServer(Planner(cache=self.port_cache,
                                         device="cpu"),
                                 default_reuse_hint=reuse_hint)

    def submit(self, plans=None, **kw):
        """Submit on both, each under its package's fault plan built from
        ``plans = (seed, kwargs)``; returns both responses."""
        out = []
        for server, a, harness in ((self.ref, self.ref_a, ref_faults),
                                   (self.port, self.a, faults)):
            if plans is None:
                out.append(server.submit(a, **kw))
            else:
                seed, fkw = plans
                with harness.injected(harness.FaultPlan(seed, **fkw)):
                    out.append(server.submit(a, **kw))
        return out

    def clear_exec(self):
        self.ref.planner._exec_cache.clear()
        self.port.planner.exec_cache.clear()


def _incidents(policy):
    return [{k: v for k, v in dataclasses.asdict(i).items()
             if k != "at_unix"} for i in policy.incidents]


def _agree(r_ref, r_port, oracle):
    assert r_port.degraded == r_ref.degraded
    assert r_port.fallback_scheme == r_ref.fallback_scheme
    assert r_port.scheme == r_ref.scheme
    assert r_port.reorder == r_ref.reorder
    assert np.array_equal(r_port.result, np.asarray(r_ref.result))
    if oracle is not None:
        assert np.array_equal(r_port.result, oracle)
    assert _incidents(get_policy()) == _incidents(ref_policy())
    want = dict(ref_policy().stats)
    got = dict(get_policy().stats)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("site", faults.SITES)
def test_ladder_recovers_like_the_reference_at_every_site(seed, site,
                                                          tmp_path):
    pair = Pair(seed,
                ref_cache=RefPlanCache(path=str(tmp_path / "ref"),
                                       max_bytes=1 << 20),
                port_cache=PlanCache(path=str(tmp_path / "port"),
                                     max_bytes=1 << 20))
    _agree(*pair.submit(), pair.oracle)              # warm, healthy
    if site == "cache_load":
        pair.ref_cache.clear_memory()
        pair.port_cache.clear_memory()
    elif site == "pack":
        pair.clear_exec()
    r_ref, r_port = pair.submit((seed, {"sites": (site,)}))
    _agree(r_ref, r_port, pair.oracle)
    if site in ("pack", "kernel_launch", "output"):
        assert r_port.degraded and r_port.fallback_scheme == "fixed"
        assert get_policy().incidents[-1].site == (
            "nonfinite" if site == "output" else site)
    else:
        assert not r_port.degraded
        assert pair.port_cache.stats["corrupt_evictions"] \
            == pair.ref_cache.stats["corrupt_evictions"] >= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_identity_rung_is_fault_suppressed_like_the_reference(seed):
    pair = Pair(seed)
    pair.submit()
    pair.clear_exec()
    r_ref, r_port = pair.submit((seed, {"sites": ("pack",),
                                        "max_fires": 2}))
    _agree(r_ref, r_port, pair.oracle)
    assert r_port.degraded and r_port.fallback_scheme == "rowwise"


@pytest.mark.parametrize("seed", SEEDS)
def test_every_rung_failing_exhausts_the_ladder_like_the_reference(
        seed, monkeypatch):
    ref_a, a, _ = _mats(seed=seed)
    causes = []
    for planner_cls, h, fp, plan_cls, exc in (
            (RefPlanner, ref_a, ref_fingerprint, RefPlan, RefExhausted),
            (lambda: Planner(device="cpu"), a, fingerprint, Plan,
             LadderExhaustedError)):
        planner = planner_cls()
        plan = plan_cls(fingerprint=fp(h), reorder="original",
                        scheme="pallas", reuse_hint=20)

        def boom(plan, a, b=None):
            raise MemoryError("host OOM")
        monkeypatch.setattr(planner, "_execute_impl", boom)
        with pytest.raises(exc) as ei:
            planner.execute(plan, h)
        causes.append([(s, type(e).__name__, str(e))
                       for s, e in ei.value.causes])
    assert causes[1] == causes[0]
    assert [s for s, _, _ in causes[1]] == ["pallas", "fixed", "rowwise"]
    assert _incidents(get_policy()) == _incidents(ref_policy())
    assert get_policy().incidents[-1].fallback == ""


@pytest.mark.parametrize("seed", SEEDS)
def test_quarantine_plans_around_and_heals_like_the_reference(seed):
    clocks = {"ref": [0.0], "port": [0.0]}
    ref_set(RefPolicy(breaker=RefBreaker(
        retry_after_s=30.0, clock=lambda: clocks["ref"][0])))
    set_policy(ResiliencePolicy(breaker=CircuitBreaker(
        retry_after_s=30.0, clock=lambda: clocks["port"][0])))
    pair = Pair(seed)
    _agree(*pair.submit(), pair.oracle)
    r_ref, r_port = pair.submit((seed, {"sites": ("kernel_launch",)}))
    _agree(r_ref, r_port, pair.oracle)
    fp = fingerprint(pair.a)
    assert not get_policy().allows(fp, "pallas", "original")
    # the next request plans around the quarantined triple...
    r_ref, r_port = pair.submit()
    _agree(r_ref, r_port, pair.oracle)
    assert r_port.scheme != "pallas" and not r_port.degraded
    assert not r_port.plan_cache_hit and not r_ref.plan_cache_hit
    # ...without evicting the cached pallas plan
    held = pair.port_cache.get(fp, 20)
    assert held is not None and held.scheme == "pallas"
    # past the retry window the half-open trial serves pallas and heals
    clocks["ref"][0] = clocks["port"][0] = 31.0
    r_ref, r_port = pair.submit()
    _agree(r_ref, r_port, pair.oracle)
    assert r_port.scheme == "pallas"
    assert get_policy().breaker.stats == ref_policy().breaker.stats
    assert get_policy().breaker.stats["healed_total"] == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_server_stats_resilience_section_matches(seed):
    pair = Pair(seed)
    pair.submit()
    pair.submit((seed, {"sites": ("kernel_launch",)}))
    s_ref = pair.ref.stats()["resilience"]
    s_port = pair.port.stats()["resilience"]
    assert s_port == s_ref
    assert (s_port["fallbacks"], s_port["incidents"],
            s_port["quarantined"]) == (1, 1, 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_faults_escape_with_the_ladder_off_like_the_reference(seed):
    ref_set(RefPolicy.disabled())
    set_policy(ResiliencePolicy.disabled())
    pair = Pair(seed)
    pair.submit()
    pair.clear_exec()
    for server, a, harness, exc in (
            (pair.ref, pair.ref_a, ref_faults,
             ref_faults.FaultInjectedError), (pair.port, pair.a, faults,
                                              FaultInjectedError)):
        with harness.injected(harness.FaultPlan(seed, sites=("pack",))):
            with pytest.raises(exc):
                server.submit(a)
    assert _incidents(get_policy()) == _incidents(ref_policy()) == []


def test_validation_is_memoized_per_operand_like_the_reference():
    pair = Pair(0)
    for _ in range(2):
        _agree(*pair.submit(), pair.oracle)
    assert get_policy().is_validated(pair.a)
    assert ref_policy().is_validated(pair.ref_a)
    bad = HostCSR(pair.a.indptr, pair.a.indices,
                  np.full(pair.a.nnz, np.nan, np.float32), pair.a.shape)
    ref_bad = RefHostCSR(pair.a.indptr, pair.a.indices, bad.data,
                         pair.a.shape)
    errors = []
    for server, h in ((pair.ref, ref_bad), (pair.port, bad)):
        with pytest.raises(ValueError) as ei:
            server.submit(h)
        errors.append(ei.value.field)
    assert errors[0] == errors[1]
    assert get_policy().rejects == ref_policy().rejects == 1


def _guards() -> tuple[int, int]:
    snap = obs_metrics.get_registry().snapshot()
    return (snap.get("output_guards{where=card}", 0),
            snap.get("output_guards{where=host}", 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poke", ["finite", "near_max", np.nan, np.inf,
                                  -np.inf])
def test_the_guard_judges_c_on_its_device_like_a_host_sum(
        poke, dtype, monkeypatch):
    """The runner's verdict, taken on C's own device (here the CPU) before
    the copy, equals the host's float64 sum's verdict on the same answer:
    one NaN, +inf or -inf raises ``NonFiniteOutputError``; a finite C
    passes, finite values near float32's top too (their float32 sum
    overflows). ``output_guards`` counts ``where=card`` alone. With the
    ladder off, ``execute`` returns a plain ``ndarray`` and raises
    nothing, whatever C holds."""
    _, a, _ = _mats()
    n = a.nrows
    rng = np.random.default_rng(7)
    c = torch.from_numpy(rng.integers(1, 4, (n, n)).astype(np.float32))
    if poke == "near_max":
        c = c * 1e38
    elif poke != "finite":
        c[5, 7] = poke
    c = c.to(dtype)
    perm = rng.permutation(n)
    want = np.empty((n, n), np.float32)
    want[np.ix_(perm, perm)] = c.float().numpy()
    finite = bool(np.isfinite(np.sum(want, dtype=np.float64)))
    assert finite == (poke in ("finite", "near_max"))
    with np.errstate(over="ignore"):
        assert np.isfinite(np.sum(want)) == (poke == "finite")
    planner = Planner(cache=PlanCache(), device="cpu")
    monkeypatch.setattr(planner, "_build_runner", lambda plan, a, b: (
        planner._unpermuted(lambda: c, perm, rows_only=False)))
    plan = Plan(fingerprint=fingerprint(a), reorder="original",
                scheme="pallas", reuse_hint=20)
    before = _guards()
    if finite:
        np.testing.assert_array_equal(
            planner._guarded_execute(plan, a, None), want)
    else:
        with pytest.raises(NonFiniteOutputError):
            planner._guarded_execute(plan, a, None)
    assert _guards() == (before[0] + 1, before[1])
    set_policy(ResiliencePolicy.disabled())
    out = planner.execute(plan, a)
    assert type(out) is np.ndarray
    np.testing.assert_array_equal(out, want)
    assert _guards() == (before[0] + 1, before[1])
