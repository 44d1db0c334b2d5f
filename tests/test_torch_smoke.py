"""``chip_smoke.py`` — the script that drives the port on a card — keeps
its contract off the card: without CUDA it exits non-zero and prints no
result, only one line naming the phase and the error; and its
``--rehearse`` dry run (every phase on the CPU at small sizes, through
the plain versions; the LM phase on the zamba2 smoke config) runs to its
end and exits 2 without the final ``{"ok": true, ...}`` line."""
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
    assert chip_smoke.run([]) == 1
    out = capsys.readouterr().out
    assert out == ("chip_smoke: failed in start: no CUDA device "
                   "available\n")


def test_rehearsal_runs_every_phase(capsys):
    assert chip_smoke.main(["--rehearse"]) == 2
    lines = capsys.readouterr().out.splitlines()
    assert not any(line.startswith('{"ok"') for line in lines)
    summary = json.loads(next(line for line in lines
                              if line.startswith('{"kernels"')))
    names = [k["name"] for k in summary["kernels"]]
    assert names == ["cluster_spgemm_windows", "cluster_spmm_compact",
                     "cluster_spgemm_padded", "cluster_spgemm_revisit",
                     "cluster_spgemm_sharded", "cluster_spmm",
                     "flash_attention", "ssd_chunk_scan"]
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
    assert len(calls) == 5
    assert all(c["exact"] for c in calls[:3])
    assert [c["SparseLinear.apply"] for c in calls[3:]] == [
        {"compact": False}, {"compact": True}]
    assert all(c["exact_vs_dense_pruned"] for c in calls[3:])
    non_finite = json.loads(next(line for line in lines if line.startswith(
        "  non-finite ")).split("non-finite ", 1)[1])
    assert non_finite["equal_to_plain"]
    assert non_finite["dead_column_reaches_its_block"]
    assert non_finite["nan"] > 0 and non_finite["inf"] > 0
    # the live-column kernels report their own work bound beside the
    # product's bound and the tile bound
    for k in summary["kernels"][:2]:
        assert k["work_bound_ms"] is not None
        assert all(c["live_column_visits"] > 0 for c in k["cases"])
    # every Sp x Sp kernel on a B with inf, -inf and NaN: position for
    # position its plain version's, and the dense strips' product
    non_finite_b = [c for k in summary["kernels"] for c in k["cases"]
                    if c["case"].startswith("non-finite B")]
    assert len(non_finite_b) == 6
    assert all(c["matched"] and c["nan"] > 0 for c in non_finite_b)
    # K9 by panels, on the clustered layer and on the same weight packed
    # without the reorder
    k9 = [c for c in summary["kernels"][5]["cases"] if "panels" in c]
    assert len(k9) == 4 and all(c["panels"] >= 1 for c in k9)
    assert all(0 < c["b_bytes_ratio"] <= 1 for c in k9)
    # K4 and K9 each with bf16 and fp16 activations on SparseLinear's
    # layer beside fp32, equal to their plain versions in B's dtype
    assert len(summary["kernels"][1]["cases"]) == 7
    for k in (summary["kernels"][1], summary["kernels"][5]):
        assert [c["dtype"] for c in k["cases"]
                if "dtype" in c][-2:] == ["torch.bfloat16", "torch.float16"]
    flash, ssd = summary["kernels"][6:]
    assert {c["dtype"] for c in flash["cases"]} == {
        "torch.float32", "torch.bfloat16", "torch.float16"}
    assert max(c["shape"][2] for c in flash["cases"]) == 160
    grouped = [c for c in ssd["cases"] if c["shape"]["heads_per_group"] > 1]
    assert grouped and grouped[0]["shared_scores_flops"] < grouped[0]["flops"]
    serving = json.loads(next(line for line in lines
                              if line.startswith("  serving "))
                         .split("serving ", 1)[1])
    assert serving["arch"] == "zamba2-2.7b" and serving["tokens_in_vocab"]
    assert serving["expected_launches"] == {"flash_attention": 2,
                                            "ssd_chunk_scan": 4}
    check = json.loads(next(line for line in lines if line.startswith(
        "  kernel vs chunked prefill ")).split("prefill ", 1)[1])
    assert check["finite"]
    assert check["max_abs_logit_diff"] <= 2e-3 * check["max_abs_logit"]


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
