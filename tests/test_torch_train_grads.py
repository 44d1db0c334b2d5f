"""The port's loss and gradients against the JAX package, on the CPU.

Every architecture's smoke config, with the JAX package's parameters
carried across by ``lm_params_from_numpy``: ``softmax_cross_entropy``
(with ignored labels), and ``loss_fn`` with every parameter's gradient
against ``jax.value_and_grad(loss_fn)`` — the reference with
``remat=True``, the port with remat on and off —, and ``use_pallas=True``
refused under autograd.

Tolerances (set from fp32 and the summation orders, before the runs):
losses within 1e-5 relative (observed ≤ 3e-7); each gradient tensor
within 1e-4 × its largest reference element (``scan`` against a loop and
XLA's dot order against oneDNN's; observed ≤ 3e-6); remat on and off bit
for bit (the same ops recomputed).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.models import layers, transformer
from repro_torch.optim import adamw
from repro_torch.train import step as train
from torch_port_helpers import (  # noqa: F401
    lm_params_pair, one_torch_thread, ref_named, trainable_pair_copy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = tuple(ref_configs.ARCH_IDS)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 32


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _batch(cfg, seed, bsz=B, seq=S):
    """(reference batch, port batch) with labels: tokens, or embeddings
    (with three differing M-RoPE position streams for vlm)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)
    ref, port = {"labels": jnp.asarray(labels)}, {"labels": _t(labels)}
    if cfg.frontend == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)
        ref["tokens"], port["tokens"] = jnp.asarray(toks), _t(toks)
    else:
        emb = rng.standard_normal((bsz, seq, cfg.d_model)).astype(np.float32)
        ref["embeddings"], port["embeddings"] = jnp.asarray(emb), _t(emb)
        if cfg.m_rope:
            t = np.arange(seq)
            p3 = np.stack([np.broadcast_to(t, (bsz, seq)),
                           np.broadcast_to(t // 3, (bsz, seq)),
                           np.broadcast_to(t % 5, (bsz, seq))]
                          ).astype(np.int32)
            ref["positions3"], port["positions3"] = jnp.asarray(p3), _t(p3)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    rcfg = ref_configs.smoke_config(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.loss_fn(rcfg, p, b, remat=True)))


def _grads(cfg, params, batch, remat):
    for p in params.parameters():
        p.grad = None
    loss = transformer.loss_fn(cfg, params, batch, remat=remat)
    loss.backward()
    out = {k: p.grad.clone() for k, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return float(loss.detach()), out


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ignore", [False, True])
def test_softmax_cross_entropy_matches_the_reference(ignore):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    if ignore:
        labels[0, :4] = -100
        labels[2, 6] = -100
    want = float(ref_layers.softmax_cross_entropy(jnp.asarray(logits),
                                                  jnp.asarray(labels)))
    got = float(layers.softmax_cross_entropy(_t(logits), _t(labels)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    all_ignored = np.full((3, 7), -100, np.int32)
    assert float(layers.softmax_cross_entropy(
        _t(logits), _t(all_ignored))) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    """``loss_fn`` and each parameter's gradient against the reference's
    ``value_and_grad``; remat on and off give the same bits."""
    rcfg, rparams, cfg, _ = lm_params_pair(arch)
    rbatch, pbatch = _batch(cfg, len(arch))
    want_loss, rgrads = _ref_value_and_grad(arch)(rparams, rbatch)
    want = ref_named(cfg, rgrads)
    params = trainable_pair_copy(cfg, rparams)
    loss, got = _grads(cfg, params, pbatch, remat=True)
    assert loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(np.abs(want[name]).max(), 1e-30)
        err = np.abs(g.numpy() - want[name]).max()
        assert err <= GRAD_REL * scale, (name, err, scale)
    loss_nr, got_nr = _grads(cfg, params, pbatch, remat=False)
    assert loss_nr == loss
    for name, g in got.items():
        assert torch.equal(g, got_nr[name]), name


def test_kernels_are_refused_under_autograd():
    _, rparams, cfg, _ = lm_params_pair("zamba2-2.7b")
    params = trainable_pair_copy(cfg, rparams)
    _, pbatch = _batch(cfg, 0)
    with pytest.raises(NotImplementedError, match="no backward"):
        transformer.loss_fn(cfg, params, pbatch, use_pallas=True)
    step = train.make_train_step(cfg, train.TrainConfig(use_pallas=True))
    with pytest.raises(NotImplementedError, match="no backward"):
        step(params, adamw.init_opt_state(params, adamw.AdamWConfig(),
                                          device="cpu"), pbatch)
    # inference with the kernels (their plain versions on the CPU) stands
    with torch.no_grad():
        got = transformer.forward(cfg, params, pbatch, use_pallas=True)
    want = transformer.forward(cfg, params.requires_grad_(False), pbatch,
                               use_pallas=True)
    assert torch.equal(got, want)
