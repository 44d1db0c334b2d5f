"""The gather tier's dense-B packs split into a value layout and a fill.

``csr_cluster_layout`` / ``csr_layout`` hold everything of a pack but its
values, with the plan's row permutation folded into the map from A's
entries to the value array; ``fill_values`` makes the operand from any
values array of that pattern. A fill from a cached layout is bit for bit
the full pack of the permuted matrix, and ``SpGEMMServer`` serves a new
values array of a packed pattern and plan by the fill alone
(``pack_layout_hits``), on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.formats import (CSR, CSRCluster, HostCSR,
                                      ValueLayout, csr_cluster_from_host,
                                      csr_cluster_layout, csr_from_host,
                                      csr_layout, fill_values)
from repro_torch.core.spgemm import spmm_clusterwise, spmm_rowwise
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.cost_model import Candidate
from repro_torch.planner.executor import GatherSpMM, tensor_nbytes
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner, _materialize
from repro_torch.resilience import faults, reset_policy
from repro_torch.serve.engine import SpGEMMServer

CSR_FIELDS = ("indptr", "indices", "data")
CLUSTER_FIELDS = ("cluster_ptr", "cols", "values", "row_base",
                  "cluster_size")


@pytest.fixture(autouse=True)
def _fresh_state():
    reset_policy()
    faults.disarm()
    get_tracer().disable()
    get_tracer().clear()
    yield
    get_tracer().disable()
    get_tracer().clear()
    reset_policy()
    faults.disarm()


def _pattern(name: str) -> HostCSR:
    """A seeded integer-valued square pattern; every one has empty rows."""
    if name == "all_empty":
        return HostCSR(np.zeros(41, np.int64), [], [], (40, 40))
    n, density, seed = {"sparse": (72, 0.05, 11), "dense": (48, 0.35, 12),
                        "hub": (64, 0.04, 13)}[name]
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    if name == "hub":
        mask[3, :] = True                    # one dense row
    mask[rng.choice(n, n // 5, replace=False)] = False     # empty rows
    dense = np.where(mask, rng.integers(1, 4, (n, n)), 0).astype(np.float32)
    return HostCSR.from_dense(dense)


def _values(h: HostCSR, seed: int) -> np.ndarray:
    """Integer values with explicit zeros (and a negative zero) among
    them: the pattern keeps its entries."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, h.nnz).astype(np.float32)
    if h.nnz:
        vals[0] = -0.0
    return vals


def _plan(h: HostCSR, scheme: str, permuted: bool):
    """(perm, boundaries, max_cluster) of ``scheme`` on ``h``; without
    ``permuted`` the plan keeps A's row order (hierarchical clusters'
    boundaries are then laid on the unpermuted rows)."""
    reorder = "degree" if permuted else "original"
    if scheme == "rowwise":
        perm, _, mc, _ = _materialize(h, Candidate(reorder, "fixed"))
        return perm, None, mc
    perm, bounds, mc, _ = _materialize(h, Candidate(reorder, scheme))
    if scheme == "hierarchical" and not permuted:
        perm = None
    return perm, [int(x) for x in bounds], mc


CASES = [(p, s, permuted)
         for p in ("sparse", "dense", "hub", "all_empty")
         for s in ("fixed", "variable", "hierarchical", "rowwise")
         for permuted in (False, True)]


@pytest.mark.parametrize("pattern,scheme,permuted", CASES)
def test_a_fill_from_the_cached_layout_is_the_full_pack(pattern, scheme,
                                                        permuted):
    h = _pattern(pattern)
    perm, bounds, mc = _plan(h, scheme, permuted)
    if permuted and h.nnz:
        assert perm is not None and not np.array_equal(
            perm, np.arange(h.nrows))
    # the layout comes from one values array, the fill gets another
    first = HostCSR(h.indptr, h.indices, _values(h, 1), h.shape)
    again = HostCSR(h.indptr, h.indices, _values(h, 2), h.shape)
    if scheme == "rowwise":
        layout = csr_layout(first, perm=perm, device="cpu")
    else:
        layout = csr_cluster_layout(first, bounds, mc, perm=perm,
                                    device="cpu")
    got = fill_values(layout, again.data)
    ap = again if perm is None else again.permute_rows(perm)
    if scheme == "rowwise":
        want, fields, run = csr_from_host(ap, device="cpu"), CSR_FIELDS, \
            spmm_rowwise
        assert isinstance(got, CSR)
    else:
        want = csr_cluster_from_host(ap, bounds, max_cluster=mc,
                                     device="cpu")
        fields, run = CLUSTER_FIELDS, spmm_clusterwise
        assert isinstance(got, CSRCluster)
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    for f in fields:
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        # bit for bit: the negative zero keeps its sign
        assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y), f
    b = np.random.default_rng(5).integers(-2, 3, (h.ncols, 6)).astype(
        np.float32)
    oracle = ap.to_dense().astype(np.float64) @ b.astype(np.float64)
    bd = torch.from_numpy(b)
    for op in (got, want):
        np.testing.assert_array_equal(run(op, bd).numpy(), oracle)


def test_a_layout_refuses_values_of_another_length():
    h = _pattern("sparse")
    layout = csr_cluster_layout(h, list(range(0, h.nrows, 8)), 8,
                                device="cpu")
    with pytest.raises(ValueError, match="values for a layout"):
        fill_values(layout, h.data[:-1])


# ---------------------------------------------------------------------------
# served through SpGEMMServer
# ---------------------------------------------------------------------------


def _seeded_plan(h: HostCSR, scheme: str) -> Plan:
    """A degree-ordered ``scheme`` SpMM plan for ``h``."""
    perm, bounds, mc = _plan(h, scheme, True)
    return Plan(fingerprint=fingerprint(h), reorder="degree", scheme=scheme,
                reuse_hint=20, max_cluster=mc, perm=perm,
                boundaries=None if bounds is None else np.asarray(bounds),
                workload="spmm")


def _seeded_server(h: HostCSR, scheme: str) -> SpGEMMServer:
    """A CPU server whose plan cache holds ``_seeded_plan(h, scheme)``."""
    cache = PlanCache()
    cache.put(_seeded_plan(h, scheme))
    return SpGEMMServer(Planner(cache=cache, device="cpu"))


def _counts() -> dict:
    s = obs_metrics.get_registry().snapshot()
    return {k: s.get(k, 0) for k in ("pack_layout_hits", "exec_cache_packs",
                                     "exec_cache_hits")}


def _moved(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def _revalued(h: HostCSR, seed: int) -> HostCSR:
    vals = np.random.default_rng(seed).integers(1, 4, h.nnz)
    return HostCSR(h.indptr, h.indices, vals.astype(np.float32), h.shape)


def _dense_b(h: HostCSR) -> np.ndarray:
    return np.random.default_rng(9).integers(-2, 3, (h.ncols, 8)).astype(
        np.float32)


@pytest.mark.parametrize("scheme", ["fixed", "rowwise"])
def test_fresh_values_on_one_pattern_repack_from_the_layout(scheme):
    h = _pattern("hub")
    b = _dense_b(h)
    srv = _seeded_server(h, scheme)
    n = 4
    requests = [_revalued(h, 100 + seed) for seed in range(n)]
    fresh = [_seeded_server(h, scheme).submit(hv, b).result
             for hv in requests]
    before = _counts()
    for hv, want in zip(requests, fresh):
        resp = srv.submit(hv, b)
        assert resp.plan_cache_hit and resp.scheme == scheme
        np.testing.assert_array_equal(resp.result, want)
        np.testing.assert_array_equal(resp.result, hv.to_dense() @ b)
    assert _moved(before) == {"pack_layout_hits": n - 1,
                              "exec_cache_packs": n, "exec_cache_hits": 0}


def test_only_the_served_pattern_and_plan_share_a_layout(monkeypatch):
    h = _pattern("hub")
    b = _dense_b(h)
    srv = _seeded_server(h, "fixed")
    srv.submit(_revalued(h, 1), b)

    # a second pattern packs in full
    other = _pattern("sparse")
    ob = _dense_b(other)
    srv.planner.cache.put(_seeded_plan(other, "fixed"))
    before = _counts()
    resp = srv.submit(other, ob)
    np.testing.assert_array_equal(resp.result, other.to_dense() @ ob)
    assert _moved(before)["pack_layout_hits"] == 0

    # the same pattern under another layout of the plan packs in full
    perm, bounds, mc = _plan(h, "variable", True)
    changed = Plan(fingerprint=fingerprint(h), reorder="degree",
                   scheme="variable", reuse_hint=20, max_cluster=mc,
                   perm=perm, boundaries=np.asarray(bounds), workload="spmm")
    hv = _revalued(h, 2)
    before = _counts()
    out = srv.planner.execute(changed, hv, b)
    np.testing.assert_array_equal(out, hv.to_dense() @ b)
    assert _moved(before) == {"pack_layout_hits": 0, "exec_cache_packs": 1,
                              "exec_cache_hits": 0}

    # the first plan's layout still serves new values
    before = _counts()
    hv = _revalued(h, 3)
    np.testing.assert_array_equal(srv.submit(hv, b).result,
                                  hv.to_dense() @ b)
    assert _moved(before)["pack_layout_hits"] == 1

    # a repeated values array hits the exec cache, with no layout lookup
    def no_lookup(*args, **kwargs):
        raise AssertionError("layout looked up on an exec-cache hit")
    monkeypatch.setattr(srv.planner.exec_cache, "layout", no_lookup)
    before = _counts()
    np.testing.assert_array_equal(srv.submit(hv, b).result,
                                  hv.to_dense() @ b)
    assert _moved(before) == {"pack_layout_hits": 0, "exec_cache_packs": 0,
                              "exec_cache_hits": 1}


def test_the_layout_outlives_the_per_value_entries():
    h = _pattern("hub")
    b = _dense_b(h)
    srv = _seeded_server(h, "fixed")
    planner = srv.planner
    planner.exec_cache.cap = 3
    before = _counts()
    for seed in range(6):
        srv.submit(_revalued(h, 10 + seed), b)
        held = [v for _, v in planner.exec_cache.items()]
        assert len(held) <= 3
        # the layout sits second-newest, behind the entry just packed
        assert isinstance(held[-2], ValueLayout)
        assert isinstance(held[-1], GatherSpMM)
        assert isinstance(held[-1].op, CSRCluster)
    assert _moved(before)["pack_layout_hits"] == 5


def test_an_evicted_layout_rebuilds_and_serves_right():
    h = _pattern("hub")
    b = _dense_b(h)
    probe = _seeded_server(h, "fixed")
    probe.submit(_revalued(h, 20), b)
    sizes = sorted(tensor_nbytes(v)
                   for _, v in probe.planner.exec_cache.items())
    srv = _seeded_server(h, "fixed")
    # room for the larger of the layout and a packed operand, not both:
    # each pack evicts the layout the one before it kept
    srv.planner.exec_cache.bytes_cap = sizes[-1] + sizes[0] // 2
    before = _counts()
    for seed in range(4):
        hv = _revalued(h, 20 + seed)
        np.testing.assert_array_equal(srv.submit(hv, b).result,
                                      hv.to_dense() @ b)
    assert _moved(before) == {"pack_layout_hits": 0, "exec_cache_packs": 4,
                              "exec_cache_hits": 0}


def test_the_pack_span_says_whether_the_layout_hit():
    h = _pattern("hub")
    b = _dense_b(h)
    srv = _seeded_server(h, "fixed")
    tracer = get_tracer()
    tracer.enable()
    try:
        srv.submit(_revalued(h, 30), b)
        srv.submit(_revalued(h, 31), b)
    finally:
        tracer.disable()
    packs = [sp for sp in tracer.spans() if sp.name == "pack"]
    assert [sp.attrs["layout_hit"] for sp in packs] == [False, True]


def test_pack_layout_hits_is_declared_as_a_counter():
    assert obs_metrics.METRIC_CATALOG["pack_layout_hits"][0] == "counter"
