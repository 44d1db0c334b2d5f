"""The port's chain workload against the JAX package's.

``Planner.execute_chain`` and ``SpGEMMServer.submit(a, hops=k)`` serve
``A^(k+1)`` hop by hop: each hop plans the current sparse intermediate
under ``workload="chain"`` and pallas hops run the sparse-C route, whose
``CompactedC → HostCSR`` result feeds the next hop. On the same
integer-valued inputs both packages must give the same sparse result
(``indptr``, ``indices`` and ``data`` array-equal) and the same per-hop
schemes, with pallas plans seeded for every hop's fingerprint, with the
heuristic planner, with an RCM-reordered first hop, with a hop too wide
for the live-pair grid (both packages' strip budgets lowered by
monkeypatch inside the test; with the card's rule patched in, the port's
hop keeps the sparse-C route) and with a faulted pallas hop that degrades
to the dense route.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.formats import HostCSR as RefHostCSR
from repro.obs import metrics as ref_metrics
from repro.planner.features import fingerprint as ref_fingerprint
from repro.planner.plan_cache import Plan as RefPlan
from repro.planner.plan_cache import PlanCache as RefPlanCache
from repro.planner.service import Planner as RefPlanner
from repro.planner.service import _materialize as ref_materialize
from repro.resilience import faults as ref_faults
from repro.resilience import get_policy as ref_policy
from repro.resilience import reset_policy as ref_reset
from repro.serve.engine import SpGEMMServer as RefServer
from repro_torch.core.formats import HostCSR
from repro_torch.obs import metrics as port_metrics
from repro_torch.planner.cost_model import Candidate
from repro_torch.planner.executor import KernelSpGEMM
from repro_torch.planner.features import fingerprint
from repro_torch.planner.plan_cache import Plan, PlanCache
from repro_torch.planner.service import Planner, _materialize
from repro_torch.resilience import faults, get_policy, reset_policy
from repro_torch.serve.engine import SpGEMMServer

from torch_port_helpers import integer_dense


@pytest.fixture(autouse=True)
def _fresh_state():
    for reset in (ref_reset, reset_policy, ref_faults.disarm,
                  faults.disarm):
        reset()
    yield
    for reset in (ref_reset, reset_policy, ref_faults.disarm,
                  faults.disarm):
        reset()


def _powers(dense, hops):
    """The exact products A², …, A^(hops+1) (integer-valued fp32)."""
    out, cur = [], dense
    for _ in range(hops):
        cur = cur @ dense
        out.append(cur)
    return out


def _seeded(dense, hops, *, reorders=None):
    """Both packages' planners with a pallas chain plan seeded (at reuse
    20) for the fingerprint of every hop's left operand (A, A², …)."""
    lefts = [dense] + _powers(dense, hops - 1)
    reorders = reorders or ["original"] * hops
    rc, pc = RefPlanCache(), PlanCache()
    for left, reorder in zip(lefts, reorders):
        rh, ph = RefHostCSR.from_dense(left), HostCSR.from_dense(left)
        perm_r, b_r, mc, _ = ref_materialize(rh, Candidate(reorder,
                                                           "pallas"))
        perm_p, b_p, _, _ = _materialize(ph, Candidate(reorder, "pallas"))
        rc.put(RefPlan(fingerprint=ref_fingerprint(rh), reorder=reorder,
                       scheme="pallas", reuse_hint=20, max_cluster=mc,
                       perm=perm_r, boundaries=b_r, workload="chain"))
        pc.put(Plan(fingerprint=fingerprint(ph), reorder=reorder,
                    scheme="pallas", reuse_hint=20, max_cluster=mc,
                    perm=perm_p, boundaries=b_p, workload="chain"))
    return RefPlanner(cache=rc), Planner(cache=pc, device="cpu")


def _same_csr(got, want):
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(np.asarray(getattr(got, field)),
                              np.asarray(getattr(want, field))), field
    assert tuple(got.shape) == tuple(want.shape)


def _chains(ref_planner, port_planner, dense, hops):
    r_out, r_plans = ref_planner.execute_chain(RefHostCSR.from_dense(dense),
                                               hops=hops, reuse_hint=20)
    p_out, p_plans = port_planner.execute_chain(HostCSR.from_dense(dense),
                                                hops=hops, reuse_hint=20)
    _same_csr(p_out, r_out)
    assert np.array_equal(p_out.to_dense(), _powers(dense, hops)[-1])
    assert [(p.scheme, p.reorder, p.workload) for p in p_plans] \
        == [(p.scheme, p.reorder, p.workload) for p in r_plans]
    return p_plans


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_seeded_pallas_chain_matches_the_reference(hops):
    dense = integer_dense(48, 48, 0.06, 100 + hops)
    ref_planner, port_planner = _seeded(dense, hops)

    def sparse_c(reg):
        return reg.get_registry().counter("kernel_launches",
                                          variant="sparse_c").value

    before = sparse_c(port_metrics)
    plans = _chains(ref_planner, port_planner, dense, hops)
    assert [p.scheme for p in plans] == ["pallas"] * hops
    assert all(p.from_cache for p in plans)
    # every pallas hop ran the sparse-C route (the JAX package, off a
    # TPU, computes the same slabs through its dense kernel and an XLA
    # compaction, so its launch labels differ)
    assert sparse_c(port_metrics) - before == hops
    # a second chain call hits the exec cache at every hop (no packing)
    packs = port_metrics.get_registry().counter("exec_cache_packs")
    n = packs.value
    _chains(ref_planner, port_planner, dense, hops)
    assert packs.value == n


def test_rcm_first_hop_matches_the_reference():
    dense = integer_dense(64, 64, 0.05, 7)
    ref_planner, port_planner = _seeded(dense, 2,
                                        reorders=["rcm", "original"])
    plans = _chains(ref_planner, port_planner, dense, 2)
    assert [p.reorder for p in plans] == ["rcm", "original"]


@pytest.mark.parametrize("reuse", [None, 1, 50])
def test_heuristic_chain_matches_the_reference(reuse):
    dense = integer_dense(64, 64, 0.05, 9)
    ref_planner = RefPlanner(cache=RefPlanCache())
    port_planner = Planner(cache=PlanCache(), device="cpu")
    r_out, r_plans = ref_planner.execute_chain(
        RefHostCSR.from_dense(dense), hops=2, reuse_hint=reuse)
    p_out, p_plans = port_planner.execute_chain(
        HostCSR.from_dense(dense), hops=2, reuse_hint=reuse)
    _same_csr(p_out, r_out)
    assert [(p.scheme, p.reorder) for p in p_plans] \
        == [(p.scheme, p.reorder) for p in r_plans]


def test_submit_hops_matches_the_reference():
    dense = integer_dense(48, 48, 0.06, 11)
    ref_planner, port_planner = _seeded(dense, 2)
    ref, port = RefServer(planner=ref_planner), SpGEMMServer(port_planner)
    for _ in range(2):
        r_ref = ref.submit(RefHostCSR.from_dense(dense), hops=2)
        r_port = port.submit(HostCSR.from_dense(dense), hops=2)
        _same_csr(r_port.result, r_ref.result)
        for field in ("fingerprint", "reorder", "scheme", "workload",
                      "plan_cache_hit", "degraded", "fallback_scheme"):
            assert getattr(r_port, field) == getattr(r_ref, field), field
        assert r_port.workload == "chain" and r_port.scheme == "pallas"
        assert r_port.plan_s >= 0.0 and r_port.execute_s >= 0.0
    assert port.stats()["plan_hits"] == ref.stats()["plan_hits"] == 2
    with pytest.raises(ValueError, match="b=None"):
        port.submit(HostCSR.from_dense(dense), dense, hops=2)


def test_wide_chain_hop_takes_the_dense_padded_route_like_the_reference(
        monkeypatch):
    import repro.kernels.ops as ref_ops
    import repro_torch.kernels.ops as port_ops
    monkeypatch.setattr(ref_ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    monkeypatch.setattr(port_ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    dense = integer_dense(200, 200, 0.015, 13)     # nnb = 2 at bn = 128
    ref_planner, port_planner = _seeded(dense, 2)

    def padded(reg):
        return reg.get_registry().counter("kernel_launches",
                                          variant="padded").value

    before = (padded(ref_metrics), padded(port_metrics))
    _chains(ref_planner, port_planner, dense, 2)
    assert (padded(ref_metrics) - before[0],
            padded(port_metrics) - before[1]) == (2, 2)


def test_wide_sparse_c_hop_under_the_cards_rule_keeps_the_live_pair_grid(
        monkeypatch):
    """On the card a hop asked for sparse C takes the live-pair grid at
    any width. With that rule patched in here (and both strip budgets
    lowered), the too-wide hops run K5 into CompactedC slabs, launch no
    padded grid, build no dense window table, and give the JAX package's
    C, which takes its dense padded route."""
    import repro.kernels.ops as ref_ops
    import repro_torch.kernels.ops as port_ops
    from repro_torch.core import formats as port_formats
    monkeypatch.setattr(ref_ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    monkeypatch.setattr(port_ops, "_COMPACT_C_STRIP_BUDGET", 4096)
    rule = port_ops.compact_grid_ok_ncols

    def cards_rule(ncols, *, sparse_c=False, device=None, **kw):
        return rule(ncols, sparse_c=sparse_c,
                    device="cuda" if sparse_c else device, **kw)

    def refuse(*_, **__):
        raise AssertionError("a dense window table was built")
    monkeypatch.setattr(port_ops, "compact_grid_ok_ncols", cards_rule)
    monkeypatch.setattr(port_ops, "compacted_c_table", refuse)
    monkeypatch.setattr(port_formats.CompactedC, "table", property(refuse))
    dense = integer_dense(200, 200, 0.015, 13)     # nnb = 2 at bn = 128
    assert not rule(dense.shape[1])
    ref_planner, port_planner = _seeded(dense, 2)

    def launches(reg, variant):
        return reg.get_registry().counter("kernel_launches",
                                          variant=variant).value

    before = (launches(ref_metrics, "padded"),
              launches(port_metrics, "padded"),
              launches(port_metrics, "sparse_c"))
    _chains(ref_planner, port_planner, dense, 2)
    assert (launches(ref_metrics, "padded") - before[0],
            launches(port_metrics, "padded") - before[1],
            launches(port_metrics, "sparse_c") - before[2]) == (2, 0, 2)


def test_faulted_pallas_hop_degrades_to_the_dense_route_like_the_reference():
    dense = integer_dense(64, 64, 0.06, 0)
    ref_planner, port_planner = _seeded(dense, 2)
    ref, port = RefServer(planner=ref_planner), SpGEMMServer(port_planner)
    with ref_faults.injected(ref_faults.FaultPlan(
            0, sites=("kernel_launch",))):
        r_ref = ref.submit(RefHostCSR.from_dense(dense), hops=2)
    with faults.injected(faults.FaultPlan(0, sites=("kernel_launch",))):
        r_port = port.submit(HostCSR.from_dense(dense), hops=2)
    _same_csr(r_port.result, r_ref.result)
    assert r_port.degraded == r_ref.degraded is True
    assert r_port.fallback_scheme == r_ref.fallback_scheme == "dense_route"
    strip = [{k: v for k, v in dataclasses.asdict(i).items()
              if k != "at_unix"} for i in get_policy().incidents]
    assert strip == [{k: v for k, v in dataclasses.asdict(i).items()
                      if k != "at_unix"} for i in ref_policy().incidents]


def test_chain_pack_stays_within_the_exec_cache_byte_cap():
    dense = integer_dense(48, 48, 0.06, 17)
    _, port_planner = _seeded(dense, 2)
    port_planner.execute_chain(HostCSR.from_dense(dense), hops=2,
                               reuse_hint=20)
    held = [v for _, v in port_planner.exec_cache.items()
            if isinstance(v, KernelSpGEMM) and v.pack.sparse_c]
    assert len(held) == 2
    one = port_planner.stats["exec_bytes"] // 2
    _, tight = _seeded(dense, 2)
    tight.exec_cache.bytes_cap = 1
    out, plans = tight.execute_chain(HostCSR.from_dense(dense), hops=2,
                                     reuse_hint=20)
    assert [p.scheme for p in plans] == ["pallas", "pallas"]
    assert np.array_equal(out.to_dense(), _powers(dense, 2)[-1])
    assert tight.stats["exec_entries"] == 0 and one > 0
