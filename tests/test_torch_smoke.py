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
    # phase 3e: the async front-end's burst (4 members of 64 rows here)
    bursts = {b["run"]: b for b in (
        json.loads(line.split("burst ", 1)[1]) for line in lines
        if line.startswith("  burst {"))}
    assert sorted(bursts) == sorted([
        "a: batched", "a: batched, profiled", "b: unbatched",
        "b: unbatched, profiled", "c: A·B pairs, batched",
        "d: chaos, faulted batch",
        "e: four worker threads", "f: unseeded plans",
        "g: float values, batched", "g: float values, unbatched"])
    for run in ("a: batched", "a: batched, profiled"):
        a = bursts[run]
        assert a["batched"] == a["requests"] == 4
        assert a["batch_sizes"] == [4] and a["schemes"] == ["pallas"]
        assert a["serve_batches"] == {"served": 1, "disbanded": 0}
        assert a["degraded"] == 0 and a["launch_amortization"] == 4.0
    assert bursts["a: batched"]["pack_c_shape"] == [256, 256]
    for run in ("b: unbatched", "b: unbatched, profiled"):
        assert bursts[run]["batched"] == 0
        assert sum(bursts[run]["routes"].values()) == 4
    assert bursts["c: A·B pairs, batched"]["batched"] == 4
    chaos = bursts["d: chaos, faulted batch"]
    assert chaos["serve_batches"] == {"served": 0, "disbanded": 1}
    assert chaos["incidents"] == ["unbatch", "fixed"]
    assert chaos["degraded"] == 1 and chaos["batched"] == 0
    assert bursts["e: four worker threads"]["degraded"] == 0
    floats = json.loads(next(line for line in lines if line.startswith(
        "  float values ")).split("values ", 1)[1])
    assert floats["max_abs_batched_vs_unbatched"] <= (
        1e-5 * floats["max_abs_value"])
    windows = summary["kernels"][0]
    assert any("block-diagonal pack" in c["case"] and c["matched"]
               for c in windows["cases"])
    assert set(windows["batch_launches"]) == {"batched", "unbatched",
                                              "pairs"}
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
    # phase 3f: benchlib's sweep (2 specs x 3 reorderings x 4 schemes
    # here), the fit from its cache, the prior beside the measured kernel
    # tier, two cold requests and the pipeline planned cold and measured
    def tagged(tag):
        return [json.loads(line[line.index("{"):]) for line in lines
                if line.startswith(tag)]
    sweep_run = tagged("  sweep run ")[0]
    assert sweep_run["products"] == 24 and sweep_run["all_equal_scipy"]
    assert sweep_run["generation"] == "torch1-cpu"
    table = tagged("  sweep {")
    assert {r["scheme"] for r in table} == {"rowwise", "fixed", "variable",
                                           "hierarchical"}
    assert all(r["geomean_speedup"] > 0 and 0 <= r["share_above_1"] <= 1
               for r in table)
    assert len(tagged("  sweep matrix ")) == 2
    assert tagged("  calibration ")[0]["n_samples"] == 22
    prior = tagged("  prior {")
    assert len(prior) == 4
    assert all(r["prior_kernel_rel"] >= 0.15 and r["measured_kernel_rel"] > 0
               for r in prior)
    cold = tagged("  cold request ")
    assert [r["matrix"] for r in cold] == ["cave", "kron"]
    assert all(r["exact"] and not r["degraded"] for r in cold)
    assert all(f"{r['reorder']}+{r['scheme']}" == r["prior_first"]
               for r in cold)
    pipe = tagged("  pipeline ")
    assert [r["mode"] for r in pipe] == ["cold", "measured"]
    assert all(r["exact"] and len(r["stages"]) == 2 for r in pipe)
    assert all(s["reuse_hint"] == 2 for r in pipe for s in r["stages"])
    # phase 3g: the LM zoo's four attention families on their smoke
    # configs, each prefill's kernel path against its chunked path, the
    # int8 KV cache and the engine on qwen3 (its shared pos past max_len)
    zoo = tagged("  zoo serving ")
    assert [(r["arch"], r["family"]) for r in zoo] == [
        ("qwen3-14b", "dense"), ("granite-moe-3b-a800m", "moe"),
        ("musicgen-large", "audio"), ("qwen2-vl-72b", "vlm")]
    assert all(r["tokens_in_vocab"] and r["expected_launches"] == {
        "flash_attention": 2, "ssd_chunk_scan": 0} for r in zoo)
    checks = tagged("  zoo kernel vs chunked prefill ")
    assert [c["arch"] for c in checks] == [r["arch"] for r in zoo]
    assert all(c["finite"] and c["max_abs_logit_diff"]
               <= 2e-3 * c["max_abs_logit"] for c in checks)
    int8 = tagged("  int8 kv ")[0]
    assert int8 == checks[0]["int8_kv"]
    assert int8["largest_share_of_tolerance"] <= 1.0
    assert 0 < int8["quantized_cache_bytes"]["int8_and_scales"] < (
        int8["quantized_cache_bytes"]["bf16"])
    eng = tagged("  engine ")[0]
    assert eng["all_done"] and eng["tokens_in_vocab"]
    assert eng["final_pos"] > eng["max_len"] == 256
    assert eng["decode_steps"] == 2 * eng["new_tokens"]
    # K10 at phase 3g's two new shapes (here scaled down: D 128 and 64)
    assert [c["shape"][2] for c in flash["cases"]][-2:] == [128, 64]
    assert all(c["matched"] for c in flash["cases"])
    # phase 3h: training — zamba2's smoke config through run_training
    # (no LM kernel launched), one step per family on the "card" (the CPU
    # here) against the CPU, compression, the non-finite skip, a resumed
    # run, and pipeline_apply in a world of one
    train = tagged("  train {")[0]
    assert train["arch"] == "zamba2-2.7b" and train["steps"] == 8
    assert train["losses"][-1] < train["losses"][0]
    assert train["lm_kernel_launches"] == {"flash_attention": 0,
                                           "ssd_chunk_scan": 0}
    assert train["profiled_step"]["lm_kernel_launches"] == \
        train["lm_kernel_launches"]
    assert train["train_flops"]["structural"] > 0
    same = tagged("  card vs cpu ")
    assert [r["family"] for r in same] == ["dense", "moe", "ssm", "hybrid",
                                           "audio", "vlm"]
    paths = tagged("  train paths ")[0]
    assert paths["non_finite"] == {"skipped": 1, "step": 0,
                                   "untouched": True}
    assert paths["resumed"]["bit_identical"]
    assert tagged("  pipeline_apply ")[0]["max_abs_err"] == 0.0


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
