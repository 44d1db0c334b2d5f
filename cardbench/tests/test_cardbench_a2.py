"""The A² cell ``kron-a2-repeat``: its configuration, its readers, and
what decides its ``correct``, through the whole harness but the look for
a card, at scale 10."""
import pytest

from cardbench import control, harness, profiling
from conftest import small_config

CELL = "kron-a2-repeat"
# what the A² cell reports: the SpMM metrics that read its layers too,
# the tier share, and no metric of SpMM's packers (no A² request packs)
A2_LAYER = {"planner.plan_ms", "planner.runner_ms", "product_roofline",
            "device.idle_pct", "planner.kernel_tier_pct"}
SPMM_ONLY = {"planner.pack_ms", "latency_p95_ms"}

def run_cell(bench, seed=2**31 + 3, system=None, trace=False):
    return harness.run(CELL, seed, 0.6, trace, device="cpu", t_start=0.0,
                       bench=bench, system=system,
                       config=small_config(bench, CELL))


def test_the_configuration_is_the_s18_generator_at_scale_14(bench):
    s14 = bench.config("graph500-kron-s14")
    s18 = bench.config("graph500-kron-s18")
    assert s14["scale"] == 14
    assert set(s18["assumed"]) < set(s14["assumed"])
    assert "dense_c" in s14["assumed"]
    assert set(s14["reduced"]) == {"scale"}
    for key in set(s18) - {"name", "deployment", "guarantee", "scale",
                           "reduced", "assumed"}:
        assert s14[key] == s18[key], key


def test_healthy_run_is_correct(bench):
    res = run_cell(bench)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"max_abs_err": [0.0, 0.0], "failed": [0, 0]}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"latency_p50_ms", "throughput_rps", "setup_s"} <= set(
        res["metrics"])
    assert not SPMM_ONLY & set(res["metrics"])


def test_control_is_not_correct(bench):
    res = run_cell(bench, system=control.Control("cpu"))
    assert not res["correct"]
    assert res["checks"]["max_abs_err"][0] >= 1.0


def test_planted_diagonal_entry_is_not_correct(bench, monkeypatch):
    """One diagonal entry of every product the planner executes is off
    by one."""
    from repro_torch.planner.service import Planner
    orig = Planner._execute_impl

    def broken(self, plan, a, b=None):
        out = orig(self, plan, a, b).copy()
        i = out.shape[0] // 2
        out[i, i] += 1.0
        return out
    monkeypatch.setattr(Planner, "_execute_impl", broken)
    res = run_cell(bench)
    assert not res["correct"]
    assert res["checks"]["max_abs_err"][0] == 1.0


def test_traced_run_reports_the_tier_share_and_no_spmm_metric(bench):
    res = run_cell(bench, trace=True)
    assert res["correct"], res["checks"]
    # the device's metrics need the card; the program's spans and
    # counters are read here: one plan serves every request, none packs
    got = set(res["metrics"])
    assert {"planner.kernel_tier_pct", "planner.plan_ms",
            "planner.runner_ms"} <= got
    assert not SPMM_ONLY & got
    assert res["metrics"]["planner.kernel_tier_pct"]["value"] in (0.0,
                                                                  100.0)


def test_the_cell_lists_its_layers_and_leaves_the_spmm_cells_theirs(bench):
    names = {m["name"] for m in bench.metrics(CELL, True)}
    assert A2_LAYER <= names and not SPMM_ONLY & names
    assert "latency_p95_ms" not in {m["name"]
                                    for m in bench.metrics(CELL, False)}
    # the tier share is the A² cell's alone; the SpMM cells keep theirs
    for cell in ("kron18-spmm-b64", "kron18-spmm-reweighted"):
        spmm = {m["name"] for m in bench.metrics(cell, True)}
        assert {"planner.plan_ms", "planner.runner_ms", "product_roofline",
                "device.idle_pct"} <= spmm
        assert "planner.kernel_tier_pct" not in spmm


def obs(**kw):
    base = dict(requests=3, spans=[], counters_before={},
                counters_after={}, batching_before=None,
                batching_after=None, profile=None, least_s=0.0)
    base.update(kw)
    return harness.Observation(**base)


@pytest.mark.parametrize("before,after,want", [
    ({"gather_tier_products": 2}, {"gather_tier_products": 6}, 0.0),
    ({}, {"kernel_tier_products": 4}, 100.0),
    ({"kernel_tier_products": 1, "gather_tier_products": 1},
     {"kernel_tier_products": 4, "gather_tier_products": 2}, 75.0),
    # a program without the counters, or a window with no product
    ({}, {}, None),
    ({"gather_tier_products": 5}, {"gather_tier_products": 5}, None)])
def test_kernel_tier_pct(bench, before, after, want):
    got = bench.reader("planner.kernel_tier_pct").read(
        obs(counters_before=before, counters_after=after))
    assert got == (None if want is None else pytest.approx(want))


def test_served_requests_carry_the_a2_least_time(bench, monkeypatch):
    """``product_roofline`` divides the least time the traffic hands each
    served request; on this cell that is A·A's work, dense C included."""
    from cardbench import roofline
    seen = []
    served = harness.Window.served

    def record(self, t_submit, t_done, least_s=None):
        seen.append(least_s)
        return served(self, t_submit, t_done, least_s)
    monkeypatch.setattr(harness.Window, "served", record)
    res = run_cell(bench)
    assert res["correct"] and seen
    cfg = small_config(bench, CELL)
    (a,), = harness.pool(cfg, 2**31 + 3)
    want = roofline.least_s(*roofline.a2_work(a.indptr, a.indices))
    assert want > 0 and all(x == pytest.approx(want) for x in seen)


def test_product_roofline_reads_the_a2_work(bench):
    """The A² cell's least time enters through its traffic kind; the
    reader divides it by the compute kernels' time, copies left out."""
    read = bench.reader("product_roofline").read
    p = profiling.Profile(1.0, 3.0, [("gather", "kernel", 1.0, 1.5),
                                     ("Memcpy DtoH (Device -> Pageable)",
                                      "memcpy", 1.5, 2.5),
                                     ("index_put", "kernel", 2.5, 3.0)])
    # 1 ms of least time over 1 s of compute kernels, the copy left out
    assert read(obs(profile=p, least_s=1e-3)) == pytest.approx(0.1)
    assert read(obs(least_s=1e-3)) is None
    assert read(obs(profile=p)) is None
    assert read(obs(profile=profiling.Profile(1.0, 3.0, []),
                    least_s=1e-3)) is None
