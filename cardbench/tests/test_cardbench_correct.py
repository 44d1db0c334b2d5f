"""What decides ``correct``: the reference against the program's CPU
path, a healthy run correct, and every fault a cell can have — and the
bfloat16 control — coming out not correct. Runs drive the whole harness
but the look for a card, at sizes a test run holds."""
import numpy as np
import pytest

from cardbench import control, graphs, harness, reference
from conftest import small_config

CELLS = ["kron18-spmm-b64", "kron18-spmm-reweighted"]


def run_cell(bench, cell, seed=2**31 + 3, system=None, trace=False):
    return harness.run(cell, seed, 0.6, trace, device="cpu", t_start=0.0,
                       bench=bench, system=system,
                       config=small_config(bench, cell))


@pytest.mark.parametrize("seed", [0, 5])
def test_reference_equals_served_products(seed):
    from repro_torch.serve.engine import SpGEMMServer
    from repro_torch.serve.frontend import AsyncSpGEMMServer
    from cardbench.system import Program
    rng = np.random.default_rng(seed)
    prog = Program("cpu")
    a = graphs.integer_values(graphs.gen_kron(9, 8, seed=seed), rng)
    b = rng.choice(np.float32([0, 1, 2]), size=(a.n, 16))
    srv = SpGEMMServer(device="cpu")
    for _ in range(2):
        got = srv.submit(prog.operand(a), b).result
        np.testing.assert_array_equal(got, reference.product(a, b))
    got = srv.submit(prog.operand(a)).result
    np.testing.assert_array_equal(got, reference.product(a))
    # distinct small members, batched block-diagonally by the front end
    members = [graphs.integer_values(graphs.gen_caveman(64, 8, seed=s), rng)
               for s in range(6)]
    fe = AsyncSpGEMMServer(SpGEMMServer(device="cpu"), workers=0)
    try:
        tickets = [fe.submit(prog.operand(m)) for m in members]
        fe.pump()
        resps = [t.result(30) for t in tickets]
    finally:
        fe.close()
    assert any(r.batched for r in resps)
    for m, r in zip(members, resps):
        np.testing.assert_array_equal(r.result, reference.product(m))


def test_max_abs_err():
    want = np.array([[1.0, 2.0]])
    assert reference.max_abs_err(np.float32([[1, 2]]), want) == 0.0
    assert reference.max_abs_err(np.float32([[1, 4]]), want) == 2.0
    assert reference.max_abs_err(np.float32([[1, np.nan]]), want) == \
        float("inf")
    assert reference.max_abs_err(np.float32([[1, 2, 3]]), want) == \
        float("inf")


@pytest.mark.parametrize("cell", CELLS)
def test_healthy_run_is_correct(bench, cell):
    res = run_cell(bench, cell)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"max_abs_err": [0.0, 0.0], "failed": [0, 0]}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   bench.metrics(cell, False)}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    res = run_cell(bench, cell, system=control.Control("cpu"))
    assert not res["correct"]
    assert res["checks"]["max_abs_err"][0] >= 1.0


def _altered(monkeypatch):
    """An answer altered where it is produced: one diagonal entry of
    every product the planner executes is off by one."""
    from repro_torch.planner.service import Planner
    orig = Planner._execute_impl

    def broken(self, plan, a, b=None):
        out = orig(self, plan, a, b).copy()
        i = out.shape[0] // 2
        out[i, min(i, out.shape[1] - 1)] += 1.0
        return out
    monkeypatch.setattr(Planner, "_execute_impl", broken)


def _half_left_out(monkeypatch):
    """Half of the batch left out: the second half of a dense B's
    columns come back zero."""
    from repro_torch.planner.service import Planner
    orig = Planner._execute_impl

    def exec_(self, plan, a, b=None):
        out = orig(self, plan, a, b)
        if plan.workload == "spmm":
            out = out.copy()
            out[:, out.shape[1] // 2:] = 0.0
        return out
    monkeypatch.setattr(Planner, "_execute_impl", exec_)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half_left_out])
def test_planted_fault_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_cell(bench, cell)
    assert not res["correct"], res["checks"]


def test_stale_values_are_not_correct(bench, monkeypatch):
    """A reweighted request answered with the first values it saw (a
    packed operand kept across new values) is wrong."""
    from repro_torch.planner import service
    monkeypatch.setattr(service, "_value_digest", lambda h: "stale")
    res = run_cell(bench, "kron18-spmm-reweighted")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,packs", [("kron18-spmm-b64", False),
                                        ("kron18-spmm-reweighted", True)])
def test_traced_run_reports_span_metrics(bench, cell, packs):
    res = run_cell(bench, cell, trace=True)
    assert res["correct"]
    # the device's metrics need the card; the program's spans are read
    # here: a reweighted request packs, a repeated one does not
    assert set(res["metrics"]) == {"planner.plan_ms", "planner.runner_ms"} \
        | ({"planner.pack_ms"} if packs else set())


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch
    from cardbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "kron18-spmm-b64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA" in out.err
