"""The product-tier counters of the port, on the CPU.

Every product ``Planner._execute_impl`` runs counts once under its
plan's tier: ``kernel_tier_products`` for the ``pallas`` scheme,
``gather_tier_products`` for ``rowwise``, ``fixed``, ``variable`` and
``hierarchical``. A ladder rung, a batched launch and a chain hop each
count under their own plan. Every dense result copied to host numpy
counts once in ``host_copies``, ``memory="pageable"`` on the CPU, where
no page-locked allocation is ever tried.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import HostCSR, block_diag_csr
from repro_torch.obs import metrics as obs_metrics
from repro_torch.planner.cost_model import Candidate
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner, _materialize
from repro_torch.resilience import faults, reset_policy
from repro_torch.serve.engine import SpGEMMServer

TIERS = ("kernel_tier_products", "gather_tier_products")
SPARSE_C = ("sparse_c_slab_bytes", "sparse_c_entries")
COPIES = ("host_copies{memory=pageable}", "host_copies{memory=pinned}")


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_policy()
    faults.disarm()
    yield
    reset_policy()
    faults.disarm()


def _matrix(n=64, seed=3) -> HostCSR:
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.08
    mask = mask | mask.T | np.eye(n, dtype=bool)
    vals = rng.integers(1, 4, (n, n)).astype(np.float32)
    return HostCSR.from_dense(np.where(mask, vals, 0.0).astype(np.float32))


def _plan(a: HostCSR, reorder: str, scheme: str,
          workload: str = "a2") -> Plan:
    if scheme in ("pallas", "rowwise"):
        perm = bounds = None
        mc = 8
    else:
        perm, bounds, mc, _ = _materialize(a, Candidate(reorder, scheme))
    return Plan(fingerprint=fingerprint(a), reorder=reorder, scheme=scheme,
                reuse_hint=20, max_cluster=mc, perm=perm, boundaries=bounds,
                workload=workload)


def _server(a: HostCSR, reorder: str, scheme: str) -> SpGEMMServer:
    """A server whose plan cache holds ``a``'s A² plan."""
    cache = PlanCache()
    cache.put(_plan(a, reorder, scheme))
    return SpGEMMServer(Planner(cache=cache, device="cpu"))


def _counts(keys=TIERS) -> tuple[int, ...]:
    snap = obs_metrics.get_registry().snapshot()
    return tuple(snap.get(k, 0) for k in keys)


def _moved(before: tuple[int, ...], keys=TIERS) -> tuple[int, ...]:
    return tuple(x - y for x, y in zip(_counts(keys), before))


@pytest.fixture
def no_pinning(monkeypatch):
    """Fail any page-locked host allocation."""
    empty = torch.empty

    def guarded(*args, **kwargs):
        assert not kwargs.get("pin_memory"), "pinned allocation tried"
        return empty(*args, **kwargs)
    monkeypatch.setattr(torch, "empty", guarded)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: (
        pytest.fail("pinned allocation tried")))


@pytest.mark.parametrize("reorder,scheme,want", [
    ("original", "pallas", (1, 0)),
    ("original", "rowwise", (0, 1)),
    ("degree", "fixed", (0, 1)),
    ("rcm", "variable", (0, 1)),
    ("original", "hierarchical", (0, 1))])
def test_an_a2_request_counts_once_under_its_tier(reorder, scheme, want):
    a = _matrix()
    srv = _server(a, reorder, scheme)
    for _ in range(2):              # a pack, then an executor-cache hit
        before = _counts()
        resp = srv.submit(a)
        assert resp.plan_cache_hit and resp.scheme == scheme
        assert not resp.degraded
        np.testing.assert_array_equal(resp.result,
                                      a.to_dense() @ a.to_dense())
        assert _moved(before) == want


def test_a_ladder_rung_counts_under_its_own_tier():
    a = _matrix()
    srv = _server(a, "original", "pallas")
    before = _counts()
    # the pallas pack fails: the product runs on the fixed rung only
    with faults.injected(faults.FaultPlan(0, sites=["pack"])):
        resp = srv.submit(a)
    assert resp.degraded and resp.fallback_scheme == "fixed"
    np.testing.assert_array_equal(resp.result, a.to_dense() @ a.to_dense())
    assert _moved(before) == (0, 1)


def test_a_failed_guard_counts_the_product_and_its_rung():
    a = _matrix()
    srv = _server(a, "original", "pallas")
    before = _counts()
    # the product runs, its output is corrupted after it: the pallas
    # product counts, then the fixed rung's, then the rowwise rung's
    with faults.injected(faults.FaultPlan(0, sites=["output"],
                                          max_fires=2)):
        resp = srv.submit(a)
    assert resp.degraded and resp.fallback_scheme == "rowwise"
    assert _moved(before) == (1, 2)


@pytest.mark.parametrize("scheme,want", [("pallas", (1, 0)),
                                         ("fixed", (0, 1))])
def test_a_batched_launch_counts_once(scheme, want):
    members = [_matrix(32, seed=s) for s in range(3)]
    pack = block_diag_csr(members).host
    plan = _plan(pack, "original", scheme, workload="batch")
    planner = Planner(cache=PlanCache(), device="cpu")
    before = _counts()
    out = planner.execute_batch(plan, pack)
    np.testing.assert_array_equal(out, pack.to_dense() @ pack.to_dense())
    assert _moved(before) == want


@pytest.mark.parametrize("schemes,want", [
    (("pallas", "pallas"), (2, 0)), (("rowwise", "rowwise"), (0, 2)),
    (("pallas", "fixed"), (1, 1))])
def test_chain_hops_count_by_their_own_plans(schemes, want):
    """A pallas hop runs the sparse-C route, another hop the dense
    ``execute`` path: each counts once, under its own plan's tier."""
    a = _matrix()
    d = a.to_dense()
    cache = PlanCache()
    for left, scheme in zip((a, HostCSR.from_dense(d @ d)), schemes):
        cache.put(_plan(left, "original", scheme, workload="chain"))
    planner = Planner(cache=cache, device="cpu")
    before = _counts()
    c, plans = planner.execute_chain(a, hops=2, reuse_hint=20)
    assert tuple(p.scheme for p in plans) == schemes
    np.testing.assert_array_equal(c.to_dense(), d @ d @ d)
    assert _moved(before) == want


def test_the_tier_counters_are_declared_as_counters():
    for name in TIERS:
        assert obs_metrics.METRIC_CATALOG[name][0] == "counter"


@pytest.mark.parametrize("reorder,scheme", [
    ("original", "pallas"), ("original", "rowwise"), ("degree", "fixed"),
    ("rcm", "variable"), ("original", "hierarchical")])
def test_an_a2_request_copies_once_to_pageable_memory(reorder, scheme,
                                                      no_pinning):
    a = _matrix()
    srv = _server(a, reorder, scheme)
    for _ in range(2):
        before = _counts(COPIES)
        resp = srv.submit(a)
        np.testing.assert_array_equal(resp.result,
                                      a.to_dense() @ a.to_dense())
        assert _moved(before, COPIES) == (1, 0)
    assert srv.planner.stats["pinned_host_bytes"] == 0


@pytest.mark.parametrize("scheme", ["pallas", "fixed"])
def test_a_batched_launch_copies_once(scheme, no_pinning):
    members = [_matrix(32, seed=s) for s in range(3)]
    pack = block_diag_csr(members).host
    plan = _plan(pack, "original", scheme, workload="batch")
    planner = Planner(cache=PlanCache(), device="cpu")
    before = _counts(COPIES)
    out = planner.execute_batch(plan, pack)
    np.testing.assert_array_equal(out, pack.to_dense() @ pack.to_dense())
    assert _moved(before, COPIES) == (1, 0)


@pytest.mark.parametrize("schemes,want", [
    (("pallas", "pallas"), 0), (("rowwise", "rowwise"), 2),
    (("pallas", "fixed"), 1)])
def test_a_chain_copies_its_dense_hops_only(schemes, want, no_pinning):
    """The sparse-C route returns C compacted, without a dense copy."""
    a = _matrix()
    d = a.to_dense()
    cache = PlanCache()
    for left, scheme in zip((a, HostCSR.from_dense(d @ d)), schemes):
        cache.put(_plan(left, "original", scheme, workload="chain"))
    planner = Planner(cache=cache, device="cpu")
    before = _counts(COPIES)
    c, _ = planner.execute_chain(a, hops=2, reuse_hint=20)
    np.testing.assert_array_equal(c.to_dense(), d @ d @ d)
    assert _moved(before, COPIES) == (want, 0)


@pytest.mark.parametrize("schemes", [("pallas", "pallas"),
                                     ("rowwise", "rowwise"),
                                     ("pallas", "fixed")])
def test_sparse_c_hops_add_their_slab_bytes_and_entries(schemes):
    """Each sparse-C hop adds its live slabs' bytes and C's entries once;
    a dense hop adds nothing."""
    a = _matrix()
    d = a.to_dense()
    c1 = HostCSR.from_dense(d @ d)
    cache = PlanCache()
    for left, scheme in zip((a, c1), schemes):
        cache.put(_plan(left, "original", scheme, workload="chain"))
    planner = Planner(cache=cache, device="cpu")
    before = _counts(SPARSE_C)
    c, _ = planner.execute_chain(a, hops=2, reuse_hint=20)
    np.testing.assert_array_equal(c.to_dense(), d @ d @ d)
    nnz = [c1.nnz, c.nnz]
    slab_bytes, entries = _moved(before, SPARSE_C)
    want = sum(n for n, s in zip(nnz, schemes) if s == "pallas")
    assert entries == want
    # a live slab is a (block_r, bn) = (8, 128) window of float32
    assert slab_bytes % (8 * 128 * 4) == 0
    assert (slab_bytes > 0) == (want > 0)
    assert slab_bytes >= 4 * entries


def test_the_sparse_c_counters_are_declared_as_counters():
    for name in SPARSE_C:
        assert obs_metrics.METRIC_CATALOG[name][0] == "counter"


def test_host_copies_is_declared_as_a_counter():
    assert obs_metrics.METRIC_CATALOG["host_copies"][0] == "counter"
