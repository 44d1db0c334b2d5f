"""``chip_smoke.py`` — the script that drives the port on a card — keeps
its contract off the card: without CUDA it exits non-zero and prints no
result, and its ``--rehearse`` dry run (every phase on the CPU at small
sizes, through the plain versions) runs to its end and exits 2 without
the final ``{"ok": true, ...}`` line."""
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_exits_non_zero_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert out == ""


def test_rehearsal_runs_every_phase(capsys):
    assert chip_smoke.main(["--rehearse"]) == 2
    lines = capsys.readouterr().out.splitlines()
    assert not any(line.startswith('{"ok"') for line in lines)
    summary = json.loads(next(line for line in lines
                              if line.startswith('{"kernels"')))
    names = [k["name"] for k in summary["kernels"]]
    assert names == ["cluster_spgemm_windows", "cluster_spmm_compact",
                     "cluster_spgemm_padded", "cluster_spgemm_revisit",
                     "cluster_spgemm_sharded"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in summary["kernels"]:
        assert keys <= set(k) and k["matched"] and k["route"] == "cuda"
        assert (ROOT / k["source"]).exists()
    served = [json.loads(line.split("request ", 1)[1]) for line in lines
              if line.startswith("  request ")]
    assert len(served) == 12 and sum(r["repeat"] for r in served) == 4
    assert all(r["exact"] and r["route_ok"] for r in served)
    routes = [r["route"] for r in served]
    assert {"dense", "sparse", "spmm", "padded", "chain", "chaos",
            "replanned"} == set(routes)
    for r in served:
        if r["route"] == "chaos":
            assert r["degraded"] and r["fallback_scheme"] == "fixed"
        elif r["route"] == "replanned":
            assert r["scheme"] != "pallas" and not r["degraded"]
        else:
            assert r["scheme"] == "pallas" and r["plan_cache_hit"]
            assert not r["degraded"]
    calls = [json.loads(line.split("call ", 1)[1]) for line in lines
             if line.startswith("  call ")]
    assert len(calls) == 3 and all(c["exact"] for c in calls)


def test_device_time_counts_device_events_once():
    """Host operators report the device time of the kernels they launch;
    only the device-side events themselves are summed."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, dev, us):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(
                                   elapsed_us=lambda: us))

    events = [ev("aten::mm", DeviceType.CPU, 900.0),
              ev("window_kernel", DeviceType.CUDA, 500.0),
              ev("Memcpy DtoH", DeviceType.CUDA, 250.0),
              ev("window_kernel", DeviceType.CUDA, 500.0)]
    prof = SimpleNamespace(events=lambda: events)
    total_s, top = chip_smoke.device_time(prof)
    assert total_s == pytest.approx(1.25e-3)
    assert top == {"window_kernel": 1.0, "Memcpy DtoH": 0.25}
