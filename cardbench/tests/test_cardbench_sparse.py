"""The sparse A² cell ``mesh9-a2-sparse``: its configuration, its
reference, what decides its ``correct``, and its two readers, through
the whole harness but the look for a card, on a 24 × 24 grid."""
import copy

import numpy as np
import pytest

from cardbench import control, graphs, harness, roofline, sparse_reference

CELL = "mesh9-a2-sparse"
CONFIG = "hypre-ij-9pt-1024"
LAYER = {"planner.plan_ms", "planner.runner_ms", "product_roofline",
         "device.idle_pct", "planner.kernel_tier_pct", "planner.to_csr_ms",
         "planner.slab_fill_pct"}


def small_config(bench, side=24) -> dict:
    cfg = copy.deepcopy(bench.config(CONFIG))
    cfg["side"] = side
    return cfg


def run_cell(bench, seed=2**33 + 7, system=None, trace=False):
    return harness.run(CELL, seed, 0.6, trace, device="cpu", t_start=0.0,
                       bench=bench, system=system,
                       config=small_config(bench))


@pytest.fixture
def kernel_tier(monkeypatch):
    """Price the kernel tier low on the CPU, so a cold chain hop plans
    ``original+pallas`` and runs the sparse-C route (its plain version)."""
    from repro_torch.planner import cost_model
    monkeypatch.setattr(cost_model, "PALLAS_INTERPRET_REL", 0.01)


def _matrix(side, seed):
    a = graphs.gen_mesh2d(side, seed=seed, stencil=9)
    return graphs.integer_values(a, np.random.default_rng(seed),
                                 list(range(1, 16)))


def _dense(a):
    out = np.zeros((a.n, a.n))
    out[np.repeat(np.arange(a.n), np.diff(a.indptr)), a.indices] = a.data
    return out


def test_the_configuration_is_hypres_9_point_grid(bench):
    cfg = bench.config(CONFIG)
    assert (cfg["side"], cfg["stencil"], cfg["relabel"]) == (1024, 9, False)
    assert cfg["values"] == list(range(1, 16))
    assert cfg["pool"] == [{"generator": "mesh2d",
                            "args": ["side", "stencil"], "count": 1}]
    assert set(cfg["reduced"]) == {"side"}
    (entry,) = [c for c in bench.spec["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == ["side"]
    # the frozen generator's 9-point pattern at the configured size
    a = graphs.gen_mesh2d(32, seed=0, stencil=9)
    assert a.nnz == 9 * 32 * 32 - 4 * 3 * 32 + 4


@pytest.mark.parametrize("seed", [0, 2**33 + 1])
def test_reference_is_the_float64_square_as_csr(seed):
    a = _matrix(11, seed)
    indptr, indices, data = sparse_reference.product(a)
    want = _dense(a) @ _dense(a)
    rows, cols = np.nonzero(want)
    assert np.array_equal(indptr, np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=a.n))]))
    assert np.array_equal(indices, cols) and data.dtype == np.float64
    assert np.array_equal(data, want[rows, cols])
    # the largest entry passes bfloat16's exact integers, so the control
    # stores some entry off
    assert data.max() > 256
    ctl = sparse_reference.control_product(a)
    assert np.array_equal(ctl[0], indptr) and np.array_equal(ctl[1], indices)
    assert sparse_reference.max_abs_err(ctl, (indptr, indices, data)) >= 1


def test_reference_in_row_blocks_equals_one_block(monkeypatch):
    a = _matrix(13, 3)
    whole = sparse_reference.product(a)
    monkeypatch.setattr(sparse_reference, "ROW_BLOCK", 7)
    for got, want in zip(sparse_reference.product(a), whole):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
@pytest.mark.parametrize("route", ["planned", "kernel_tier"])
def test_served_sparse_square_equals_the_reference(seed, route, request):
    """``submit(a, hops=1)`` on a small 9-point mesh, on the plan the CPU
    takes and on the kernel tier's sparse-C route."""
    from repro_torch.serve.engine import SpGEMMServer
    from cardbench.system import Program
    if route == "kernel_tier":
        request.getfixturevalue("kernel_tier")
    a = _matrix(20, seed)
    srv = SpGEMMServer(device="cpu")
    want = sparse_reference.product(a)
    for _ in range(2):
        resp = srv.submit(Program("cpu").operand(a), hops=1)
        assert (resp.scheme == "pallas") == (route == "kernel_tier")
        got = resp.result
        assert np.array_equal(got.indptr, want[0])
        assert np.array_equal(got.indices, want[1])
        assert np.array_equal(got.data.astype(np.float64), want[2])


def test_a2_csr_work_by_hand():
    # rows: 0 -> {0, 1}, 1 -> {1}, 2 -> {0, 2}: 8 products (see
    # test_cardbench_roofline); C = A·A has 6 entries
    a = graphs.from_coo([0, 0, 1, 2, 2], [0, 1, 1, 0, 2], np.ones(5), 3)
    flops, nbytes = sparse_reference.a2_csr_work(a, 6)
    assert flops == 16
    assert nbytes == 2 * (4 * 4 + 8 * 5) + (4 * 4 + 8 * 6)


@pytest.mark.parametrize("tier", [False, True])
def test_healthy_run_is_correct(bench, tier, request):
    if tier:
        request.getfixturevalue("kernel_tier")
    res = run_cell(bench)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"max_abs_err": [0.0, 0.0], "failed": [0, 0]}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"latency_p50_ms", "throughput_rps",
                                   "setup_s"}


def test_control_is_not_correct(bench):
    res = run_cell(bench, system=control.Control("cpu"))
    assert not res["correct"]
    assert 1.0 <= res["checks"]["max_abs_err"][0] < float("inf")


def _dropped(c):
    i = c.nnz // 2
    row = int(np.searchsorted(c.indptr, i, side="right")) - 1
    indptr = c.indptr.copy()
    indptr[row + 1:] -= 1
    return type(c)(indptr, np.delete(c.indices, i), np.delete(c.data, i),
                   c.shape)


def _shifted(c):
    # the last entry of the first row that ends before the last column
    row = int(np.flatnonzero(c.indices[c.indptr[1:] - 1] < c.shape[1] - 1)[0])
    indices = c.indices.copy()
    indices[c.indptr[row + 1] - 1] += 1
    return type(c)(c.indptr, indices, c.data, c.shape)


def _revalued(c):
    data = c.data.copy()
    data[c.nnz // 3] += 1.0
    return type(c)(c.indptr, c.indices, data, c.shape)


@pytest.mark.parametrize("fault,err", [(_dropped, float("inf")),
                                       (_shifted, float("inf")),
                                       (_revalued, 1.0)])
@pytest.mark.parametrize("tier", [False, True])
def test_planted_fault_is_not_correct(bench, monkeypatch, request, fault,
                                      err, tier):
    """Every answer the chain returns altered: an entry dropped, a column
    moved, a value off by one."""
    from repro_torch.planner.service import Planner
    if tier:
        request.getfixturevalue("kernel_tier")
    orig = Planner.execute_chain

    def broken(self, a, **kw):
        c, plans = orig(self, a, **kw)
        return fault(c), plans
    monkeypatch.setattr(Planner, "execute_chain", broken)
    res = run_cell(bench)
    assert not res["correct"]
    assert res["checks"]["max_abs_err"][0] == err


def test_traced_run_on_the_kernel_tier_reports_the_cells_layers(
        bench, kernel_tier):
    res = run_cell(bench, trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # the device's metrics need the card
    assert set(got) == LAYER - {"product_roofline", "device.idle_pct"}
    assert got["planner.kernel_tier_pct"]["value"] == 100.0
    assert 0 < got["planner.slab_fill_pct"]["value"] <= 100
    assert got["planner.to_csr_ms"]["value"] > 0


def test_the_cell_lists_its_layers(bench):
    assert {m["name"] for m in bench.metrics(CELL, True)} == LAYER
    assert {m["name"] for m in bench.metrics(CELL, False)} == {
        "latency_p50_ms", "throughput_rps", "setup_s"}
    for other in ("kron18-spmm-b64", "kron18-spmm-reweighted",
                  "kron-a2-repeat"):
        names = {m["name"] for m in bench.metrics(other, True)}
        assert not {"planner.to_csr_ms", "planner.slab_fill_pct"} & names


def test_served_requests_carry_the_csr_least_time(bench, monkeypatch):
    seen = []
    served = harness.Window.served

    def record(self, t_submit, t_done, least_s=None):
        seen.append(least_s)
        return served(self, t_submit, t_done, least_s)
    monkeypatch.setattr(harness.Window, "served", record)
    res = run_cell(bench)
    assert res["correct"] and seen
    (a,), = harness.pool(small_config(bench), 2**33 + 7)
    c_nnz = sparse_reference.product(a)[0][-1]
    want = roofline.least_s(*sparse_reference.a2_csr_work(a, c_nnz))
    assert want > 0 and all(x == pytest.approx(want) for x in seen)


def obs(**kw):
    base = dict(requests=4, spans=[], counters_before={},
                counters_after={}, batching_before=None,
                batching_after=None, profile=None, least_s=0.0)
    base.update(kw)
    return harness.Observation(**base)


def test_to_csr_ms(bench):
    read = bench.reader("planner.to_csr_ms").read
    spans = [("kernel", 0.0, 1.0), ("copy", 0.1, 0.2),
             ("to_csr", 0.2, 0.5), ("to_csr", 2.2, 2.3)]
    assert read(obs(spans=spans)) == pytest.approx(1e3 * 0.4 / 4)
    assert read(obs(spans=spans[:2])) is None
    assert read(obs(spans=spans, requests=0)) is None


@pytest.mark.parametrize("before,after,want", [
    ({}, {"sparse_c_slab_bytes": 4096, "sparse_c_entries": 32}, 3.125),
    ({"sparse_c_slab_bytes": 4096, "sparse_c_entries": 1024},
     {"sparse_c_slab_bytes": 12288, "sparse_c_entries": 1536}, 25.0),
    # a program without the counters, or a window with no sparse-C product
    ({}, {}, None),
    ({"sparse_c_slab_bytes": 4096}, {"sparse_c_slab_bytes": 4096}, None)])
def test_slab_fill_pct(bench, before, after, want):
    got = bench.reader("planner.slab_fill_pct").read(
        obs(counters_before=before, counters_after=after))
    assert got == (None if want is None else pytest.approx(want))
