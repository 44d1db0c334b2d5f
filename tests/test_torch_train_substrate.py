"""The training substrate of the port against the JAX package, on the CPU:
AdamW (schedule, clipping, bf16 moments, updates on equal gradients),
int8 error-feedback compression, the synthetic data pipeline, the
elastic control plane, the launch presets and the checkpoint manager.

Tolerances: compression, the data pipeline, the elastic helpers and the
checkpoint's manifest and files are *equal* to the reference's (dict
keys in sorted order, as the reference's tree flattening takes them); the
learning rate within two fp32 ulps (XLA's cosine against the C
library's); AdamW's parameters and moments within 1e-6 of the largest
value on equal gradients (the same fp32 operations, the global norm
summed in another order).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.data import pipeline as ref_data
from repro.distributed import compression as ref_comp
from repro.distributed import elastic as ref_elastic
from repro.launch import presets as ref_presets
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data import pipeline as data
from repro_torch.distributed import compression, elastic
from repro_torch.launch import presets
from repro_torch.models.layers import ParamGroup
from repro_torch.optim import adamw
from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR_RTOL = 2.0 ** -22
UPDATE_RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _tree(seed, scale=1.0):
    """A small parameter-like dict: a matrix, a vector, a 3-D stack."""
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": (scale * rng.standard_normal(5)).astype(np.float32),
            "stack": (scale * rng.standard_normal((2, 3, 4))).astype(
                np.float32)}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_warmup_cosine_matches_the_reference():
    cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    rcfg = ref_adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10,
                                 total_steps=100)
    for s in range(0, 121):
        want = float(ref_adamw.warmup_cosine(rcfg, jnp.asarray(s)))
        assert float(adamw.warmup_cosine(cfg, s)) == pytest.approx(
            want, rel=LR_RTOL, abs=0.0), s
    assert float(adamw.warmup_cosine(cfg, 100)) == pytest.approx(
        cfg.lr_peak * cfg.lr_min_ratio, rel=1e-3)


def test_clip_by_global_norm_matches_the_reference():
    tree = {"a": np.full((4,), 10.0, np.float32),
            "b": np.full((3,), -10.0, np.float32)}
    want, want_norm = ref_adamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()}, 1.0)
    got, norm = adamw.clip_by_global_norm([_t(tree["a"]), _t(tree["b"])],
                                          1.0)
    assert float(norm) == float(want_norm) == pytest.approx(np.sqrt(700),
                                                            rel=1e-6)
    for g, k in zip(got, ("a", "b")):
        assert np.array_equal(g.numpy(), np.asarray(want[k]))
    assert float(adamw.global_norm(got)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_updates_match_the_reference(moment_dtype, clip_norm):
    """Three updates from the same weights with the same gradients
    (clipped, then bias-corrected; decay on every tensor)."""
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10,
              clip_norm=clip_norm)
    cfg = adamw.AdamWConfig(moment_dtype=getattr(torch, moment_dtype), **kw)
    rcfg = ref_adamw.AdamWConfig(moment_dtype=getattr(jnp, moment_dtype),
                                 **kw)
    p0 = _tree(0)
    params = {k: _t(v) for k, v in p0.items()}
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state = adamw.init_opt_state(params, cfg, device="cpu")
    rstate = ref_adamw.init_opt_state(rparams, rcfg)
    assert all(m.dtype == getattr(torch, moment_dtype)
               for m in state.mu.values())
    for step in range(3):
        g = _tree(10 + step, scale=3.0)
        rparams, rstate, rm = ref_adamw.adamw_update(
            rparams, {k: jnp.asarray(v) for k, v in g.items()}, rstate, rcfg)
        params, state, m = adamw.adamw_update(
            params, {k: _t(v) for k, v in g.items()}, state, cfg)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=LR_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
    assert int(state.step) == int(rstate.step) == 3
    for k in p0:
        want = np.asarray(rparams[k])
        np.testing.assert_allclose(params[k].numpy(), want, rtol=0,
                                   atol=UPDATE_RTOL * np.abs(want).max())
        for got_m, want_m in ((state.mu[k], rstate.mu[k]),
                              (state.nu[k], rstate.nu[k])):
            # bf16 moments: one bf16 ulp where the fp32 values straddle
            # a rounding point
            want_m = np.asarray(want_m, np.float32)
            np.testing.assert_allclose(
                got_m.float().numpy(), want_m,
                rtol=2.0 ** -8 if moment_dtype == "bfloat16" else 0,
                atol=UPDATE_RTOL * np.abs(want_m).max())


def test_adamw_reduces_quadratic():
    """The reference's own test, on the port: minimise |w|^2."""
    cfg = adamw.AdamWConfig(lr_peak=0.1, warmup_steps=5, total_steps=200,
                            weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_opt_state(params, cfg, device="cpu")
    for _ in range(150):
        params, state, _ = adamw.adamw_update(params, {"w": 2 * params["w"]},
                                              state, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_names_a_module_by_its_parameters():
    group = ParamGroup(w=torch.ones(3), inner=ParamGroup(b=torch.zeros(2)))
    state = adamw.init_opt_state(group, adamw.AdamWConfig(), device="cpu")
    assert list(state.mu) == ["w", "inner.b"]
    with pytest.raises(KeyError):
        adamw.adamw_update(group, {"w": torch.ones(3)}, state,
                           adamw.AdamWConfig())


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_compress_decompress_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(1000) * 10.0 ** rng.uniform(-6, 2)
         ).astype(np.float32)
    if seed == 0:   # max 127, so scale 1: codes on the half-way points,
        # rounded half to even
        x = np.concatenate([[127.0, -126.5], np.arange(-10, 10) + 0.5]
                           ).astype(np.float32)
    if seed == 1:   # all zeros: the 1e-12 floor on the scale
        x = np.zeros(17, np.float32)
    want = ref_comp.compress_decompress(jnp.asarray(x))
    got = compression.compress_decompress(_t(x))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if seed == 0:
        assert np.array_equal(got[0].numpy(), np.round(x))
    deq, res = got
    np.testing.assert_allclose((deq + res).numpy(), x, rtol=1e-6, atol=1e-6)
    assert float(res.abs().max()) <= float(np.abs(x).max()) / 127 + 1e-30


def test_ef_compress_grads_equals_the_reference_over_steps():
    """Three steps of error feedback: compressed gradients (fp32 and
    bf16) and residuals equal to the reference's."""
    res = compression.init_residuals({k: _t(v) for k, v in _tree(0).items()})
    rres = ref_comp.init_residuals({k: jnp.asarray(v)
                                    for k, v in _tree(0).items()})
    for step in range(3):
        g = _tree(20 + step)
        pg = {k: _t(v) for k, v in g.items()}
        rg = {k: jnp.asarray(v) for k, v in g.items()}
        pg["b"] = pg["b"].to(torch.bfloat16)
        rg["b"] = rg["b"].astype(jnp.bfloat16)
        got, res = compression.ef_compress_grads(pg, res)
        want, rres = ref_comp.ef_compress_grads(rg, rres)
        for k in g:
            assert got[k].dtype == pg[k].dtype
            assert np.array_equal(got[k].float().numpy(),
                                  np.asarray(want[k], np.float32)), k
            assert np.array_equal(res[k].numpy(), np.asarray(rres[k])), k


def test_compression_then_adamw_matches_the_reference():
    """The train step's order — error-feedback compression, then AdamW —
    on the same gradients for three steps."""
    cfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=5)
    rcfg = ref_adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=1,
                                 total_steps=5)
    p0 = _tree(1)
    params = {k: _t(v) for k, v in p0.items()}
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state = adamw.init_opt_state(params, cfg, device="cpu")
    rstate = ref_adamw.init_opt_state(rparams, rcfg)
    res = compression.init_residuals(params)
    rres = ref_comp.init_residuals(rparams)
    for step in range(3):
        g = _tree(30 + step)
        cg, res = compression.ef_compress_grads(
            {k: _t(v) for k, v in g.items()}, res)
        rcg, rres = ref_comp.ef_compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, rres)
        params, state, _ = adamw.adamw_update(params, cg, state, cfg)
        rparams, rstate, _ = ref_adamw.adamw_update(rparams, rcg, rstate,
                                                    rcfg)
    for k in p0:
        want = np.asarray(rparams[k])
        np.testing.assert_allclose(params[k].numpy(), want, rtol=0,
                                   atol=UPDATE_RTOL * np.abs(want).max())
        assert np.array_equal(res[k].numpy(), np.asarray(rres[k]))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontend,m_rope", [("tokens", False),
                                             ("embeddings", False),
                                             ("embeddings", True)])
@pytest.mark.parametrize("shard,num_shards", [(0, 1), (0, 2), (1, 2)])
def test_make_batch_equals_the_reference(frontend, m_rope, shard,
                                         num_shards):
    kw = dict(vocab_size=101, seq_len=40, global_batch=8, seed=3,
              frontend=frontend, d_model=12, m_rope=m_rope)
    for step in (0, 5):
        want = ref_data.make_batch(ref_data.DataConfig(**kw), step, shard,
                                   num_shards)
        got = data.make_batch(data.DataConfig(**kw), step, shard,
                              num_shards, device="cpu")
        assert list(got) == list(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == getattr(torch, w.dtype.name), k
            assert np.array_equal(got[k].numpy(), w), k


def test_data_deterministic_and_shardable():
    cfg = data.DataConfig(vocab_size=101, seq_len=16, global_batch=8, seed=3)
    b1 = data.make_batch(cfg, step=5, device="cpu")
    assert torch.equal(b1["tokens"],
                       data.make_batch(cfg, step=5, device="cpu")["tokens"])
    assert not torch.equal(b1["tokens"],
                           data.make_batch(cfg, 6, device="cpu")["tokens"])
    s0 = data.make_batch(cfg, 5, 0, 2, device="cpu")
    s1 = data.make_batch(cfg, 5, 1, 2, device="cpu")
    assert s0["tokens"].shape == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    it = data.host_batch_iterator(cfg, start_step=5, device="cpu")
    step, b = next(it)
    assert step == 5 and torch.equal(b["labels"], b1["labels"])
    assert next(it)[0] == 6


# ---------------------------------------------------------------------------
# elastic control plane and presets
# ---------------------------------------------------------------------------


def test_elastic_helpers_equal_the_reference():
    for healthy, model, pod in [(512, 8, None), (448, 8, None), (7, 8, None),
                                (512, 16, 256), (300, 4, 256), (255, 4, 256),
                                (9, 3, 4)]:
        try:
            want = ref_elastic.plan_remesh(healthy, model, pod)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                elastic.plan_remesh(healthy, model, pod)
            continue
        assert elastic.plan_remesh(healthy, model, pod) == want
    assert elastic.reassign_shards(10, [0, 2, 5]) == \
        ref_elastic.reassign_shards(10, [0, 2, 5])
    rng = np.random.default_rng(0)
    port, ref = elastic.StragglerMonitor(), ref_elastic.StragglerMonitor()
    for step in range(80):
        for host in range(4):
            t = 1.0 + 0.01 * rng.standard_normal()
            if host == 3 and step > 60:
                t *= 3
            port.record(host, t)
            ref.record(host, t)
        assert port.stragglers() == ref.stragglers()
    assert port.stragglers() == [3]
    guards = (elastic.NaNGuard(max_consecutive=3),
              ref_elastic.NaNGuard(max_consecutive=3))
    for loss in (1.0, float("nan"), 2.0, float("inf"), float("nan")):
        assert guards[0].check(loss) == guards[1].check(loss)
    assert guards[0].total_skipped == guards[1].total_skipped == 3
    for g in guards:
        with pytest.raises(FloatingPointError):
            g.check(float("nan"))


def test_presets_equal_the_reference():
    assert set(presets.PRESETS) == set(ref_presets.PRESETS)
    for arch, want in ref_presets.PRESETS.items():
        got = presets.preset_for(arch)
        assert got.microbatches == want.microbatches
        assert got.note == want.note
        assert str(got.param_dtype).removeprefix("torch.") == \
            jnp.dtype(want.param_dtype).name
        assert str(got.moment_dtype).removeprefix("torch.") == \
            jnp.dtype(want.moment_dtype).name
    assert presets.preset_for("no-such-arch") == presets.LaunchPreset()


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _ckpt_tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    port = {"w": _t(w), "nested": {"b": _t(b).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    ref = {"w": jnp.asarray(w), "nested": {"b": jnp.asarray(b, jnp.bfloat16)},
           "step": jnp.asarray(7, jnp.int32)}
    return port, ref


def test_checkpoint_layout_equals_the_reference(tmp_path):
    """The same dict tree saved by both packages: the same manifest
    (paths, files, shapes, logical dtypes, CRCs) and the same bytes in
    every ``.npy``; each package restores the other's."""
    port_tree, ref_tree = _ckpt_tree()
    CheckpointManager(str(tmp_path / "port")).save(3, port_tree,
                                                   extra={"loss": 1.5})
    ref_ckpt.CheckpointManager(str(tmp_path / "ref")).save(
        3, ref_tree, extra={"loss": 1.5})
    dirs = [tmp_path / k / "step_000000003" for k in ("port", "ref")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    assert [(e["path"], e["dtype"]) for e in manifests[0]["leaves"]] == [
        ("nested/b", "bfloat16"), ("step", "int32"), ("w", "float32")]
    for e in manifests[0]["leaves"]:
        assert (dirs[0] / e["file"]).read_bytes() == \
            (dirs[1] / e["file"]).read_bytes()
    like, _ = _ckpt_tree(seed=1)
    got, extra = CheckpointManager(str(tmp_path / "ref")).restore(3, like)
    assert got is like and extra == {"loss": 1.5}
    assert torch.equal(got["nested"]["b"], port_tree["nested"]["b"])
    assert torch.equal(got["w"], port_tree["w"])
    assert int(got["step"]) == 7


def test_checkpoint_roundtrip_of_a_module_and_opt_state(tmp_path):
    group = ParamGroup(w=torch.arange(6.0).reshape(2, 3),
                       inner=ParamGroup(b=torch.ones(4, dtype=torch.bfloat16)))
    cfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    state = adamw.init_opt_state(group, cfg, device="cpu")
    group, state, _ = adamw.adamw_update(
        group, {"w": torch.ones(2, 3), "inner.b": torch.ones(4)}, state, cfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": group, "opt": state})
    paths = [e["path"] for e in json.loads(
        (tmp_path / "step_000000001" / "manifest.json").read_text())["leaves"]]
    assert paths == ["opt/step", "opt/mu/inner.b", "opt/mu/w",
                     "opt/nu/inner.b", "opt/nu/w", "params/w",
                     "params/inner.b"]
    fresh = ParamGroup(w=torch.zeros(2, 3), inner=ParamGroup(
        b=torch.zeros(4, dtype=torch.bfloat16)))
    fresh_state = adamw.init_opt_state(fresh, cfg, device="cpu")
    step, _, _ = mgr.restore_latest({"params": fresh, "opt": fresh_state})
    assert step == 1 and int(fresh_state.step) == 1
    for (name, a), b in zip(group.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(state.mu[name], fresh_state.mu[name])
        assert torch.equal(state.nu[name], fresh_state.nu[name])


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]
    like = {"w": torch.zeros(2)}
    step, got, _ = mgr.restore_latest(like)
    assert step == 4 and float(got["w"][0]) == 4.0
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        like) is None


def test_checkpoint_refuses_corruption_and_mismatches(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(4, dtype=torch.float32)})
    d = tmp_path / "step_000000001"
    fn = next(f for f in os.listdir(d) if f.endswith(".npy"))
    arr = np.load(d / fn)
    arr[0] += 1
    np.save(d / fn, arr)
    like = {"w": torch.full((4,), -1.0)}
    with pytest.raises(IOError, match="CRC"):
        mgr.restore(1, like)
    assert torch.equal(like["w"], torch.full((4,), -1.0))   # untouched
    mgr.save(2, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(2, {"w": torch.zeros(5)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        mgr.restore(2, {"v": torch.zeros(4)})


def test_checkpoint_ignores_a_stale_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_000000009.tmp")
    assert mgr.latest_step() is None        # half-written: invisible
    mgr.save(9, {"w": torch.ones(2)})       # replaces the stale .tmp
    assert mgr.all_steps() == [9]
    assert not (tmp_path / "step_000000009.tmp").exists()
