"""The port's train step against the JAX package, on the CPU.

The JAX package's smoke-config parameters carried across by
``lm_params_from_numpy`` and the same ``make_batch`` data: three steps
of ``make_train_step`` with 1 and 2 microbatches and compression on and
off, microbatching against the full batch (the reference's own test),
``_split_micro``, fp32 accumulation of bf16 gradients, and the
non-finite step skip.

Tolerances (set from fp32 and the summation orders, before the runs):
losses within 1e-5 relative; the learning rate within two fp32 ulps (the
schedule's cosine); grad norms and each moment within 1e-4 × the
reference's largest element (XLA's summation order against oneDNN's);
parameters after three AdamW steps within 1e-6 absolute, but for the
elements whose gradient is near Adam's ε (see the 3-step test). With
compression, the int8 codes of gradients that differ by 1e-7 may round
the other way, so the compressed steps are held against the reference by
their losses and, part by part, on equal inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.data import pipeline as ref_data
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.data import pipeline as data
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import step as train
from torch_port_helpers import (  # noqa: F401
    lm_params_pair, one_torch_thread, ref_named, trainable_pair_copy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-6
LR_RTOL = 2.0 ** -22      # two fp32 ulps: XLA's cos against the C library's


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _data_batches(cfg, steps, bsz=4, seq=32):
    d = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=bsz,
             seed=5, frontend=cfg.frontend, d_model=cfg.d_model,
             m_rope=cfg.m_rope)
    rd, pd = ref_data.DataConfig(**d), data.DataConfig(**d)
    return [(ref_data.make_batch(rd, s), data.make_batch(pd, s,
                                                         device="cpu"))
            for s in range(steps)]


@functools.lru_cache(maxsize=None)
def _ref_train_step(arch, micro, compress):
    rcfg = ref_configs.smoke_config(arch)
    return jax.jit(ref_step.make_train_step(rcfg, ref_step.TrainConfig(
        microbatches=micro, compress_grads=compress,
        optimizer=ref_adamw.AdamWConfig(**OPT))))


OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


def _three_steps(arch, micro, compress):
    """Three steps of both packages from the same weights on the same
    data. Returns (per-step metrics pairs, port params, port state,
    reference params, reference state, the port config)."""
    from repro.distributed import compression as ref_comp
    from repro_torch.distributed import compression
    rcfg, rparams, cfg, _ = lm_params_pair(arch)
    ref_fn = _ref_train_step(arch, micro, compress)
    tcfg = train.TrainConfig(microbatches=micro, compress_grads=compress,
                             optimizer=adamw.AdamWConfig(**OPT))
    fn = train.make_train_step(cfg, tcfg)
    params = trainable_pair_copy(cfg, rparams)
    opt = adamw.init_opt_state(params, tcfg.optimizer, device="cpu")
    rp, ropt = rparams, ref_adamw.init_opt_state(rparams,
                                                 ref_adamw.AdamWConfig())
    res = compression.init_residuals(params) if compress else None
    rres = ref_comp.init_residuals(rparams) if compress else None
    metrics = []
    for rbatch, pbatch in _data_batches(cfg, 3):
        if compress:
            rp, ropt, rres, rm = ref_fn(rp, ropt, rbatch, rres)
            params, opt, res, m = fn(params, opt, pbatch, res)
        else:
            rp, ropt, rm = ref_fn(rp, ropt, rbatch)
            params, opt, m = fn(params, opt, pbatch)
        metrics.append((m, rm))
    return metrics, params, opt, rp, ropt, cfg


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-2.7b"])
def test_three_train_steps_match_the_reference(arch, micro):
    """Losses, grad norms, learning rates, parameters and moments after
    three steps. Adam's first update of an element is lr · g / (|g| + ε)
    with ε = 1e-8: where |g| is itself near ε, the fp32 gradients' 1e-7
    difference moves that element's update by up to lr. Such elements
    may exceed the 1e-6 bound, if they are at most 1e-3 of all (observed
    on zamba2: 20 of 186,528; on qwen3: none) and each stays within 2 ×
    the summed learning rates."""
    metrics, params, opt, rp, ropt, cfg = _three_steps(arch, micro, False)
    lr_sum = 0.0
    for m, rm in metrics:
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=GRAD_REL)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]),
                                               rel=LR_RTOL)
        assert m["skipped"] == int(rm["skipped"]) == 0
        lr_sum += float(rm["lr"])
    assert int(opt.step) == int(ropt.step) == 3
    want = ref_named(cfg, rp)
    off = total = 0
    for name, p in params.named_parameters():
        err = np.abs(p.detach().numpy() - want[name])
        off += int((err > PARAM_ATOL).sum())
        total += err.size
        assert err.max() <= 2 * lr_sum, (name, err.max())
    assert off <= 1e-3 * total, (off, total)
    for key in ("mu", "nu"):
        ref_m = ref_named(cfg, getattr(ropt, key))
        for name, v in getattr(opt, key).items():
            scale = max(np.abs(ref_m[name]).max(), 1e-30)
            err = np.abs(v.numpy() - ref_m[name]).max()
            assert err <= GRAD_REL * scale, (key, name, err, scale)


@pytest.mark.parametrize("micro", [1, 2])
def test_three_compressed_train_steps(micro):
    """With compression on: each step's loss against the reference's
    (the int8 codes of gradients that differ by 1e-7 may round the other
    way, so parameters are not compared here: the compressor is equal to
    the reference's on equal gradients, and compression + AdamW is held
    against the reference on carried gradients, in
    ``test_torch_train_substrate.py``); and the port's step equal, bit
    for bit, to its parts — ``microbatch_grads``, ``ef_compress_grads``,
    ``adamw_update`` — on a second copy of the weights."""
    from repro_torch.distributed import compression
    metrics, params, opt, _, _, cfg = _three_steps("qwen3-14b", micro, True)
    for m, rm in metrics:
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]),
                                                 rel=LOSS_RTOL)
        assert m["skipped"] == int(rm["skipped"]) == 0
    _, rparams, _, _ = lm_params_pair("qwen3-14b")
    tcfg = train.TrainConfig(microbatches=micro, compress_grads=True,
                             optimizer=adamw.AdamWConfig(**OPT))
    fn = train.make_train_step(cfg, tcfg)
    a, b = trainable_pair_copy(cfg, rparams), trainable_pair_copy(cfg, rparams)
    opt_a = adamw.init_opt_state(a, tcfg.optimizer, device="cpu")
    opt_b = adamw.init_opt_state(b, tcfg.optimizer, device="cpu")
    res_a = compression.init_residuals(a)
    res_b = compression.init_residuals(b)
    for _, batch in _data_batches(cfg, 3):
        a, opt_a, res_a, m = fn(a, opt_a, batch, res_a)
        grads, loss = train.microbatch_grads(cfg, tcfg, b, batch)
        grads, res_b = compression.ef_compress_grads(grads, res_b)
        b, opt_b, mb = adamw.adamw_update(b, grads, opt_b, tcfg.optimizer)
        assert torch.equal(m["loss"], loss)
        assert torch.equal(m["grad_norm"], mb["grad_norm"])
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert torch.equal(opt_a.mu[name], opt_b.mu[name]), name
        assert torch.equal(opt_a.nu[name], opt_b.nu[name]), name
        assert torch.equal(res_a[name], res_b[name]), name


def test_microbatching_matches_full_batch():
    """grad-accum over 4 microbatches == one full-batch step (same data),
    as the reference's own test checks it."""
    _, rparams, cfg, _ = lm_params_pair("qwen3-14b")
    ocfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    (_, batch), = _data_batches(cfg, 1, bsz=8)
    out = {}
    for micro in (1, 4):
        params = trainable_pair_copy(cfg, rparams)
        opt = adamw.init_opt_state(params, ocfg, device="cpu")
        fn = train.make_train_step(cfg, train.TrainConfig(
            microbatches=micro, optimizer=ocfg))
        params, opt, m = fn(params, opt, batch)
        out[micro] = (float(m["loss"]), {k: p.detach().clone() for k, p in
                                         params.named_parameters()})
    assert out[1][0] == pytest.approx(out[4][0], rel=1e-4)
    for name, p1 in out[1][1].items():
        np.testing.assert_allclose(p1.numpy(), out[4][1][name].numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_split_micro_matches_the_reference():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (4, 6)).astype(np.int32),
             "positions3": rng.integers(0, 9, (3, 4, 6)).astype(np.int32),
             "scale": np.float32(rng.standard_normal(5))}
    want = ref_step._split_micro({k: jnp.asarray(v)
                                  for k, v in batch.items()}, 2)
    got = train._split_micro({k: _t(v) for k, v in batch.items()}, 2)
    for k in batch:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["positions3"].shape == (2, 3, 2, 6)
    assert got["scale"].shape == (2, 5)


def test_nonfinite_step_skipped():
    """A NaN in a parameter makes the loss NaN: the update is skipped,
    parameters, moments and step left exactly as they were (the
    reference's ``test_nonfinite_step_skipped``)."""
    _, rparams, cfg, _ = lm_params_pair("qwen3-14b")
    params = trainable_pair_copy(cfg, rparams)
    with torch.no_grad():
        params["final_norm"][0] = float("nan")
    ocfg = adamw.AdamWConfig()
    opt = adamw.init_opt_state(params, ocfg, device="cpu")
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    (_, batch), = _data_batches(cfg, 1, bsz=2, seq=16)
    fn = train.make_train_step(cfg, train.TrainConfig(optimizer=ocfg))
    params, new_opt, m = fn(params, opt, batch)
    assert m["skipped"] == 1
    assert int(new_opt.step) == 0
    for k, p in params.named_parameters():
        p = p.detach()
        assert torch.equal(p.isnan(), before[k].isnan()), k
        assert torch.equal(p.nan_to_num(), before[k].nan_to_num()), k
    assert all(not v.any() for v in new_opt.mu.values())
    assert all(not v.any() for v in new_opt.nu.values())


def test_microbatch_grads_sum_16_bit_gradients_in_fp32():
    """bf16 parameters over 2 microbatches: each microbatch's bf16
    gradient widened and summed in fp32, then halved — the reference's
    fp32 accumulator — and returned in fp32; with one microbatch, each
    gradient in bf16 as autograd gives it."""
    _, rparams, cfg, _ = lm_params_pair("qwen3-14b")
    params = trainable_pair_copy(cfg, rparams).to(torch.bfloat16)
    (_, batch), = _data_batches(cfg, 1)
    halves = train._split_micro(batch, 2)
    want = {}
    for i in range(2):
        loss = transformer.loss_fn(cfg, params, {k: v[i] for k, v in
                                                 halves.items()})
        loss.backward()
        for k, p in params.named_parameters():
            want[k] = want.get(k, 0) + p.grad.float()
            p.grad = None
    got, _ = train.microbatch_grads(cfg, train.TrainConfig(microbatches=2),
                                    params, batch)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], w / 2), k
    one, _ = train.microbatch_grads(cfg, train.TrainConfig(), params, batch)
    assert all(g.dtype == torch.bfloat16 for g in one.values())
