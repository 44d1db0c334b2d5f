"""The port's launch layer — input specs, presets, applicability, the
roofline arithmetic, report rendering and a smoke dry-run — the
counterpart of ``tests/test_launch.py``, held against the JAX package's
own functions where both have them."""
import json

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

from repro.configs import base as ref_configs
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import presets as ref_presets
from repro.launch import roofline as ref_roofline
from repro.launch.specs import input_specs as ref_input_specs
from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_applicable
from repro_torch.launch import presets, roofline
from repro_torch.launch.report import (_diagnosis, dryrun_table, load,
                                       roofline_table)
from repro_torch.launch.specs import input_specs


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_the_reference(arch, shape):
    want = ref_input_specs(arch, shape)
    got = input_specs(arch, shape)
    assert set(got) == set(want)
    for k, v in got.items():
        assert isinstance(v, FakeTensor)          # nothing allocated
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.is_floating_point() == jax.numpy.issubdtype(
            want[k].dtype, jax.numpy.floating), k
    ss = SHAPES[shape]
    lead = got.get("tokens", got.get("embeddings"))
    if ss.kind == "decode":
        assert lead.shape[1] == 1
    else:
        assert tuple(lead.shape[:2]) == (ss.global_batch, ss.seq_len)


def test_presets_match_the_reference():
    assert set(presets.PRESETS) == set(ref_presets.PRESETS)
    for arch in ARCH_IDS:
        p, r = presets.preset_for(arch), ref_presets.preset_for(arch)
        assert p.microbatches == r.microbatches
        assert str(p.param_dtype).split(".")[-1] == r.param_dtype.__name__
        assert str(p.moment_dtype).split(".")[-1] == r.moment_dtype.__name__
        assert SHAPES["train_4k"].global_batch % p.microbatches == 0


def test_applicability_matrix():
    live = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, ss in SHAPES.items():
            ok, why = shape_applicable(cfg, ss)
            if ok:
                live += 1
            else:
                assert name == "long_500k" and not cfg.subquadratic
                assert "full-attention" in why
    assert live == 32  # 10×3 + 2 long_500k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    for name in SHAPES:
        assert roofline.model_flops_for_cell(cfg, SHAPES[name]) == \
            ref_roofline.model_flops_for_cell(rcfg, REF_SHAPES[name])


@pytest.mark.parametrize("bottleneck", ["compute", "memory", "collective"])
def test_analyze_matches_the_reference(bottleneck):
    """The same counts and collectives, with the reference's limits in the
    port's HW, give the reference's report."""
    stats = {"compute": {"flops": 1e18, "bytes": 1e12, "bytes_ub": 1e13},
             "memory": {"flops": 1e12, "bytes": 1e15, "bytes_ub": 1e16},
             "collective": {"flops": 1e12, "bytes": 1e9, "bytes_ub": 1e10}
             }[bottleneck]
    hlo = ("ENTRY %main (p: bf16[4096]) -> bf16[4096] {\n"
           "  %p = bf16[4096] parameter(0)\n"
           "  ROOT %ar = bf16[1048576]{0} all-reduce(%p), to_apply=%s\n}")
    from repro.launch.hlo_graph import collective_stats as ref_colls
    colls = {k: {kk: vv for kk, vv in v.items() if kk != "wire_bytes_tpu"}
             for k, v in ref_colls(hlo).items() if k != "_loops"}
    cost = {"flops": 1e12, "bytes accessed": 1e9}
    mem = {"temp_size_in_bytes": 1}
    rcfg, cfg = ref_configs.get_config("qwen3-14b"), get_config("qwen3-14b")
    want = ref_roofline.analyze("qwen3-14b", REF_SHAPES["train_4k"],
                                "single", 256, cost, mem, hlo, rcfg, stats)
    hw = roofline.HW(peak_flops=ref_roofline.HW().peak_flops,
                     hbm_bw=ref_roofline.HW().hbm_bw,
                     link_bw=ref_roofline.HW().link_bw)
    got = roofline.analyze("qwen3-14b", SHAPES["train_4k"], "single", 256,
                           cost, mem, colls, cfg, stats, hw=hw)
    assert got.bottleneck == want.bottleneck == bottleneck
    w, g = want.to_json(), got.to_json()
    assert set(g) == set(w)
    for k in w:
        if k == "collectives":
            assert g[k]["_total"]["wire_bytes"] == \
                w[k]["_total"]["wire_bytes"]
        elif isinstance(w[k], float):
            assert g[k] == pytest.approx(w[k], rel=1e-12), k
        else:
            assert g[k] == w[k], k


def test_h100_limits_and_dtype_peak():
    hw = roofline.HW()
    assert (hw.peak_flops, hw.peak_flops_fp32, hw.hbm_bw, hw.link_bw) == \
        (989.4e12, 66.9e12, 3.35e12, 50e9)
    assert "H100" in hw.name
    assert hw.peak_for(torch.float32) == 66.9e12
    assert hw.peak_for(torch.bfloat16) == hw.peak_for() == 989.4e12


def test_model_flops_decode_scaling():
    cfg = get_config("qwen3-14b")
    d = roofline.model_flops_for_cell(cfg, SHAPES["decode_32k"])
    t = roofline.model_flops_for_cell(cfg, SHAPES["train_4k"])
    assert t / d == pytest.approx(3 * 4096 * 256 / 128)


def test_report_renders_rows():
    rows = [{"arch": "a", "shape": "train_4k", "mesh": "single",
             "status": "skipped", "reason": "x" * 100},
            {"arch": "b", "shape": "decode_32k", "mesh": "single",
             "status": "ok",
             "roofline": {
                 "compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5,
                 "bottleneck": "memory", "useful_ratio": 0.8,
                 "peak_fraction": 0.3, "notes": "",
                 "memory_stats": {"temp_size_in_bytes": 2**30,
                                  "argument_size_in_bytes": 2**29},
                 "collectives": {"all-reduce": {"count": 3, "bytes": 1,
                                                "wire_bytes": 2}}}},
            {"arch": "c", "shape": "train_4k", "mesh": "single",
             "status": "error", "error": "boom"}]
    dt = dryrun_table(rows)
    rt = roofline_table(rows)
    assert "SKIP" in dt and "| b |" in dt and "**FAIL**" in dt
    assert "memory-bound" in rt


def test_diagnosis_strings():
    base = {"useful_ratio": 0.8, "bottleneck": "compute"}
    assert "near-roofline" in _diagnosis(base)
    assert "remat" in _diagnosis({**base, "useful_ratio": 0.3})
    assert "K10" in _diagnosis({**base, "useful_ratio": 0.3})
    mem = _diagnosis({**base, "bottleneck": "memory"})
    assert "fused attention" in mem and "bf16" in mem
    assert "overlap" in _diagnosis({**base, "bottleneck": "collective"})


@pytest.fixture
def fake_2x2():
    from repro_torch.launch.mesh import ensure_fake_world, make_test_mesh
    ensure_fake_world(4)
    yield make_test_mesh(data=2, model=2)
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_dry_run_writes_a_json_that_report_renders(tmp_path, fake_2x2,
                                                         kind):
    from repro_torch.launch.dryrun import run_cell
    cfg = smoke_config("granite-moe-3b-a800m")
    shape = ShapeSpec(f"smoke_{kind}", kind, 32, 4)
    r = run_cell("granite-moe-3b-a800m", shape.name, False,
                 out_dir=str(tmp_path), verbose=False, mesh=fake_2x2,
                 cfg=cfg, shape=shape)
    assert r["status"] == "ok", r.get("traceback")
    with open(tmp_path / f"granite-moe-3b-a800m__{shape.name}__single.json"
              ) as f:
        saved = json.load(f)
    rf = saved["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck",
                "useful_ratio", "peak_fraction", "memory_stats",
                "collectives", "xla_flops_per_device"):
        assert key in rf
    ms = rf["memory_stats"]
    assert ms["alias_size_in_bytes"] == ms["generated_code_size_in_bytes"] \
        == 0
    assert ms["argument_size_in_bytes"] > 0 and ms["temp_size_in_bytes"] > 0
    assert rf["chips"] == 4 and rf["flops_total"] > 0
    assert rf["collectives"]["_total"]["count"] > 0
    rows = load(directory=str(tmp_path))
    assert "| granite-moe-3b-a800m |" in dryrun_table(rows)
    assert "| granite-moe-3b-a800m |" in roofline_table(rows)


def test_failed_cell_is_recorded_and_the_cli_exits_non_zero(
        tmp_path, fake_2x2, monkeypatch):
    import dataclasses
    from repro_torch.launch import dryrun
    bad = dataclasses.replace(smoke_config("qwen3-14b"), family="bogus")
    shape = ShapeSpec("smoke_train", "train", 32, 4)
    r = dryrun.run_cell("qwen3-14b", shape.name, False, out_dir=str(tmp_path),
                        verbose=False, mesh=fake_2x2, cfg=bad, shape=shape)
    assert r["status"] == "error" and "Traceback" in r["traceback"]
    with open(tmp_path / "qwen3-14b__smoke_train__single.json") as f:
        assert json.load(f)["status"] == "error"
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: r)
    with pytest.raises(SystemExit, match="1 cell"):
        dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k",
                     "--mesh", "single", "--out", str(tmp_path)])


def test_cli_skips_an_inapplicable_cell(tmp_path):
    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    with open(tmp_path / "qwen3-14b__long_500k__single.json") as f:
        assert json.load(f)["status"] == "skipped"
