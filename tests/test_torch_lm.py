"""The port's LM serving slice against the JAX package, on the CPU.

Seeded numpy inputs go through both packages: the SSD chunk scan (K11)
and flash attention (K10) — the port's plain versions, which the CPU
takes, against the JAX kernels in interpret mode — their ops-level
adapters, the model's modules, and ``forward`` / ``prefill`` /
``decode_step`` of the zamba2 and mamba2 smoke configs with the JAX
package's parameters carried across by ``lm_params_from_numpy``. The JAX
models run with ``use_pallas=False`` (their flash path has no interpret
switch and cannot run on the CPU).

Tolerances: the kernels' fp32 sums run in another order in the two
packages — attention within 1e-5 (16-bit attention within the bound its
test states), the SSD scan within 2e-3 (as
``tests/test_extensions.py`` holds the JAX kernel to its chunked path);
model logits within 1e-4 absolute + 1e-4 relative (observed ≈ 6e-6 on
logits of magnitude ≈ 4); the port's kernel path against its chunked path
within 2e-3.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ssd_chunk import ssd_chunk_scan as ref_ssd_scan
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import mamba2 as ref_mamba2
from repro.models import transformer as ref_tf
from repro_torch.configs import base as port_configs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.cluster_spmm import cluster_spmm
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_tolerance)
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention, layers, mamba2, transformer
from repro_torch.serve.engine import make_serve_step
from torch_port_helpers import lm_params_pair

ARCHS = ("zamba2-2.7b", "mamba2-370m")
LOGIT_RTOL = LOGIT_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _ssd_inputs(bh, nc, q, p, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bh, nc, q, p)) * 0.3).astype(np.float32)
    a = (-rng.uniform(0.0, 0.3, (bh, nc, q))).astype(np.float32)
    b = rng.standard_normal((bh, nc, q, n)).astype(np.float32)
    c = rng.standard_normal((bh, nc, q, n)).astype(np.float32)
    return x, a, b, c


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    for getter in ("get_config", "smoke_config"):
        ref = getattr(ref_configs, getter)(arch)
        port = getattr(port_configs, getter)(arch)
        assert ref.__dict__ == port.__dict__
        assert ref.param_count() == port.param_count()
        assert ref.active_param_count() == port.active_param_count()
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS


def test_zamba2_published_size():
    cfg = port_configs.get_config("zamba2-2.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
            cfg.d_ff, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_chunk,
            cfg.vocab_size) == (54, 2560, 32, 80, 10240, 64, 80, 256, 32000)
    assert cfg.num_attn_layers == 9
    assert round(cfg.param_count() / 1e9, 2) == 2.42


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(_t(x), _t(w)).numpy(),
        np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    pos = np.arange(10)[None].repeat(2, 0)
    cos, sin = layers.rope_cos_sin(_t(pos), 16, 1e4)
    rc, rs = ref_layers.rope_cos_sin(jnp.asarray(pos), 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rc), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rs), atol=2e-6)
    xr = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(_t(xr), _t(np.asarray(rc)), _t(np.asarray(rs))
                          ).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(xr), rc, rs)),
        atol=1e-6)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    wg, wu = (rng.standard_normal((8, 12)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((12, 8)).astype(np.float32)
    np.testing.assert_allclose(
        layers.swiglu(_t(h), _t(wg), _t(wu), _t(wd)).numpy(),
        np.asarray(ref_layers.swiglu(*(jnp.asarray(t)
                                       for t in (h, wg, wu, wd)))),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K11: the SSD chunk scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,nc,q,p,n", [
    (2, 4, 16, 8, 16),
    (3, 2, 32, 16, 8),
    (2, 1, 100, 16, 16),        # one chunk, Q not a multiple of 64
    (2, 2, 64, 8, 32),
])
def test_ssd_scan_plain_matches_the_jax_kernel(bh, nc, q, p, n):
    x, a, b, c = _ssd_inputs(bh, nc, q, p, n, seed=bh * q + n)
    y, h = ssd_chunk_scan(_t(x), _t(a), _t(b), _t(c))
    ry, rh = ref_ssd_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(c), interpret=True)
    assert y.shape == (bh, nc, q, p) and h.shape == (bh, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("bh,rep", [(8, 4), (6, 3), (4, 4)])
def test_ssd_scan_plain_on_groups_matches_the_jax_kernel(bh, rep):
    """B and C per group of ``rep`` heads (head bh reads group
    bh // rep): the plain version against the JAX kernel on the same
    operands expanded per head."""
    x, a, b, c = _ssd_inputs(bh, 2, 32, 8, 16, seed=bh + rep)
    bg, cg = b[::rep].copy(), c[::rep].copy()
    y, h = ssd_chunk_scan(_t(x), _t(a), _t(bg), _t(cg), heads_per_group=rep)
    ry, rh = ref_ssd_scan(jnp.asarray(x), jnp.asarray(a),
                          jnp.asarray(np.repeat(bg, rep, axis=0)),
                          jnp.asarray(np.repeat(cg, rep, axis=0)),
                          interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=2e-3,
                               atol=2e-3)
    with pytest.raises(ValueError, match="heads_per_group"):
        ssd_chunk_scan(_t(x), _t(a), _t(b), _t(c), heads_per_group=rep)


@pytest.mark.parametrize("s,chunk,g", [(64, 16, 1), (48, 48, 2), (40, 8, 4)])
def test_fused_ssd_matches_the_reference(s, chunk, g):
    """The ops-level adapter (dt folding, group broadcast, layouts)
    against the JAX package's ``fused_ssd`` (interpret mode) and
    ``ssd_chunked``."""
    rng = np.random.default_rng(s + g)
    bsz, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 0.3, (bsz, s, h)).astype(np.float32)
    a_log = rng.uniform(-1.0, 0.5, h).astype(np.float32)
    b = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    y, st = ops.fused_ssd(_t(x), _t(dt), _t(a_log), _t(b), _t(c), chunk)
    args = [jnp.asarray(t) for t in (x, dt, a_log, b, c)]
    ry, rst = ref_ops.fused_ssd(*args, chunk, interpret=True)
    cy, cst = jax.jit(ref_mamba2.ssd_chunked, static_argnums=5)(*args, chunk)
    assert st.shape == (bsz, h, p, n)
    for want_y, want_st in ((ry, rst), (cy, cst)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   rtol=2e-3, atol=2e-3)


def test_ssd_chunked_matches_the_reference():
    rng = np.random.default_rng(3)
    bsz, s, h, p, g, n = 2, 64, 4, 8, 2, 8
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 0.3, (bsz, s, h)).astype(np.float32)
    a_log = rng.uniform(-1.0, 0.5, h).astype(np.float32)
    b = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    init = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    y, st = mamba2.ssd_chunked(*(_t(t) for t in (x, dt, a_log, b, c)), 16,
                               init_state=_t(init))
    ry, rst = jax.jit(lambda *a: ref_mamba2.ssd_chunked(
        *a[:5], 16, init_state=a[5]))(
            *(jnp.asarray(t) for t in (x, dt, a_log, b, c, init)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(rst), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K10: flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,sq,sk,d,causal", [
    (2, 128, 128, 16, True),
    (2, 256, 256, 80, True),
    (3, 128, 256, 80, False),
])
def test_flash_plain_matches_the_jax_kernel(bh, sq, sk, d, causal):
    rng = np.random.default_rng(bh * sq + d)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [80, 160])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_plain_in_16_bits_matches_the_jax_kernel(dtype, d):
    """bf16 and fp16 q, k, v: output in q's dtype, P rounded to v's dtype
    before P·V, as in the JAX kernel (interpret mode); D = 160 past the
    port kernel's first instantiation."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 256, d)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (_t(t).to(getattr(torch, dtype)) for t in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(ref_flash(*(jnp.asarray(t, dtype=getattr(jnp, dtype))
                                  for t in (q, k, v)), causal=True,
                                interpret=True))
    assert want.dtype.name == dtype
    # per element, three unit roundoffs of what each row sums (P is
    # rounded against each package's running max: 128-key blocks in the
    # JAX kernel, the final max in the plain version)
    tol = flash_attention_tolerance(tq, tk, tv, got, causal=True).numpy()
    err = np.abs(got.float().numpy() - want.astype(np.float32))
    assert (err <= tol).all(), float((err / tol).max())
    # P is rounded: the plain version differs from unrounded P·V
    unrounded = torch.softmax(
        (tq.float() @ tk.float().transpose(1, 2)) / d ** 0.5
        + torch.triu(torch.full((256, 256), -1e30), 1), -1) @ tv.float()
    assert not torch.equal(got, unrounded.to(got.dtype))


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [16, 80])
def test_flash_mha_matches_the_reference(rep, d):
    rng = np.random.default_rng(rep * d)
    hkv = 2
    q = rng.standard_normal((2, hkv * rep, 128, d)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 128, d)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 128, d)).astype(np.float32)
    got = ops.flash_mha(_t(q), _t(k), _t(v)).numpy()
    want = np.asarray(ref_ops.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [64, 300])
def test_gqa_attention_matches_the_reference(s):
    """Chunked (s = 64, one block) and odd-length (s = 300: plain masked)
    paths, GQA with 2 query heads per KV head; the port's flash path
    agrees with both."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    want = np.asarray(ref_attention.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=32,
        kv_chunk=32))
    for use_pallas in (False, True):
        got = attention.gqa_attention(_t(q), _t(k), _t(v), q_chunk=32,
                                      kv_chunk=32, use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    kc = rng.standard_normal((2, 50, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 50, 2, 16)).astype(np.float32)
    got = attention.decode_attention(_t(q[:, :1]), _t(kc), _t(vc), 17)
    want = ref_attention.decode_attention(jnp.asarray(q[:, :1]),
                                          jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(17))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def _same_tokens_where_decided(got_logits, want_logits):
    """Greedy tokens agree wherever the reference's top-2 margin exceeds
    the logit tolerance (a near-tie may break either way)."""
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * (
        LOGIT_ATOL + LOGIT_RTOL * np.abs(top2[..., 1]))
    same = got_logits.argmax(-1) == want_logits.argmax(-1)
    assert same[decided].all()


def test_mamba2_block_matches_the_reference():
    rcfg, rparams, cfg, params = lm_params_pair("mamba2-370m")
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    rlp = jax.tree.map(lambda a: a[0], rparams["layers"]["ssm"])
    out, (st, buf) = mamba2.mamba2_block(cfg, params["layers"][0], _t(u),
                                         return_state=True)
    rout, (rst, rbuf) = jax.jit(lambda p, x: ref_mamba2.mamba2_block(
        rcfg, p, x, return_state=True))(rlp, jnp.asarray(u))
    for got, want in ((out, rout), (st, rst), (buf, rbuf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    y, st2, buf2 = mamba2.mamba2_decode_block(
        cfg, params["layers"][0], _t(u[:, :1]), st, buf)
    ry, rst2, rbuf2 = jax.jit(lambda p, x, st, buf: (
        ref_mamba2.mamba2_decode_block(rcfg, p, x, st, buf)))(
            rlp, jnp.asarray(u[:, :1]), rst, rbuf)
    for got, want in ((y, ry), (st2, rst2), (buf2, rbuf2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


MAX_LEN = 72


@functools.lru_cache(maxsize=None)
def _ref_serving(arch):
    """The JAX package's prefill and decode step for ``arch``'s smoke
    config, jitted once per architecture (one cache length)."""
    rcfg = ref_configs.smoke_config(arch)
    return (jax.jit(lambda p, b: ref_tf.prefill(rcfg, p, b, MAX_LEN)),
            jax.jit(lambda p, b, c: ref_tf.decode_step(rcfg, p, b, c)))


@pytest.mark.parametrize("seq", [64, 24])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_the_reference(arch, seq):
    """forward and prefill (logits and every cache field) against the
    reference's prefill, then four greedy decode steps; seq 64 is two SSM
    chunks, seq 24 the single-chunk fallback."""
    _, rparams, cfg, params = lm_params_pair(arch)
    ref_prefill, ref_step = _ref_serving(arch)
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    rlogits, rcache = ref_prefill(rparams, {"tokens": jnp.asarray(toks)})
    fwd = transformer.forward(cfg, params, {"tokens": _t(toks).long()})
    _close(fwd.numpy(), np.asarray(rlogits))
    logits, cache = transformer.prefill(cfg, params,
                                        {"tokens": _t(toks).long()}, MAX_LEN)
    _close(logits.numpy(), np.asarray(rlogits))
    assert cache["pos"] == int(rcache["pos"]) == seq
    assert set(cache) == set(rcache)
    for key in set(rcache) - {"pos"}:
        _close(cache[key].numpy(), np.asarray(rcache[key]))
    tok = np.asarray(rlogits)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(4):
        got, cache = transformer.decode_step(
            cfg, params, {"tokens": _t(tok).long()}, cache)
        want, rcache = ref_step(rparams, {"tokens": jnp.asarray(tok)},
                                rcache)
        got, want = got.numpy(), np.asarray(want)
        _close(got, want)
        _same_tokens_where_decided(got[:, -1], want[:, -1])
        tok = want[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert cache["pos"] == seq + 4


@pytest.mark.parametrize("seq", [64, 40, 300])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_matches_the_chunked_path(arch, seq):
    """use_pallas=True (on the CPU: the kernels' plain versions) against
    the model's own chunked path; seq 40 and 300 take the single-chunk
    SSD fallback, 300 the odd-length attention path too."""
    _, _, cfg, params = lm_params_pair(arch)
    toks = _t(np.random.default_rng(seq).integers(
        0, cfg.vocab_size, (2, seq))).long()
    kern, kcache = transformer.prefill(cfg, params, {"tokens": toks},
                                       seq + 2, use_pallas=True)
    ref, rcache = transformer.prefill(cfg, params, {"tokens": toks},
                                      seq + 2, use_pallas=False)
    scale = float(ref.abs().max())
    assert float((kern - ref).abs().max()) <= 2e-3 * scale
    for key in set(rcache) - {"pos"}:
        assert float((kcache[key] - rcache[key]).abs().max()) <= 2e-3 * max(
            1.0, float(rcache[key].abs().max()))


@pytest.mark.parametrize("seq", [64, 40])
def test_bf16_kernel_path_prefill_matches_the_reference(seq):
    """The zamba2 smoke model with every parameter in bf16 (the JAX
    package's ``init_params(dtype=bfloat16)``, carried across): the
    kernel path (``use_pallas=True``; on the CPU the plain versions, with
    P rounded to bf16 in attention) against the JAX package's bf16
    prefill and the port's own chunked path. bf16 rounds at other places
    in the two packages over the layers, so the bound is 2^-4 of the
    largest logit against the reference (the port's chunked path meets
    it too) and 2^-5 between the port's two paths."""
    rcfg, rparams, cfg, params = lm_params_pair("zamba2-2.7b")
    # a copy: Module.to converts in place, and the pair is shared by
    # every test in the process
    params = copy.deepcopy(params).to(torch.bfloat16)
    rb = jax.tree.map(lambda t: t.astype(jnp.bfloat16), rparams)
    toks = np.random.default_rng(seq).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    batch = {"tokens": _t(toks).long()}
    # the shared fp32 pair is left as it was
    assert all(p.dtype == torch.float32
               for p in lm_params_pair("zamba2-2.7b")[3].parameters())
    kern, _ = transformer.prefill(cfg, params, batch, seq + 2,
                                  use_pallas=True)
    chunked, _ = transformer.prefill(cfg, params, batch, seq + 2,
                                     use_pallas=False)
    want, _ = jax.jit(lambda p, b: ref_tf.prefill(rcfg, p, b, seq + 2))(
        rb, {"tokens": jnp.asarray(toks)})
    v = cfg.vocab_size
    assert kern.dtype == torch.bfloat16
    want = np.asarray(want).astype(np.float32)[..., :v]
    kern = kern.float().numpy()[..., :v]
    chunked = chunked.float().numpy()[..., :v]
    scale = np.abs(want).max()
    assert np.isfinite(kern).all()
    assert np.abs(kern - want).max() <= 2.0 ** -4 * scale
    assert np.abs(chunked - want).max() <= 2.0 ** -4 * scale
    assert np.abs(kern - chunked).max() <= 2.0 ** -5 * scale


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_lm_params_from_numpy_matches_init_params_layout():
    _, _, cfg, loaded = lm_params_pair("zamba2-2.7b")
    fresh = transformer.init_params(cfg, 0, device="cpu")
    got = {k: tuple(v.shape) for k, v in loaded.named_parameters()}
    want = {k: tuple(v.shape) for k, v in fresh.named_parameters()}
    assert got == want
    assert not any(p.requires_grad for p in fresh.parameters())


def test_run_serving_on_the_cpu():
    a = port_serve.run_serving("zamba2-2.7b", batch=2, prompt_len=40, gen=5,
                               device="cpu")
    b = port_serve.run_serving("zamba2-2.7b", batch=2, prompt_len=40, gen=5,
                               device="cpu", use_pallas=False)
    assert set(a) == {"prefill_s", "decode_s", "decode_tok_per_s", "tokens"}
    assert a["tokens"].shape == (2, 5)
    assert (a["tokens"] < 128).all()
    assert np.array_equal(a["tokens"], b["tokens"])


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.run_serving("mamba2-370m")
    cfg = port_configs.smoke_config("mamba2-370m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg)


def test_cli_runs_the_smoke_config(capsys):
    port_serve.main(["--arch", "mamba2-370m", "--device", "cpu", "--gen",
                     "3"])
    assert capsys.readouterr().out.startswith("[serve] prefill")


def test_sampled_serve_step_follows_its_generator():
    cfg = port_configs.smoke_config("mamba2-370m")
    params = transformer.init_params(cfg, 3, device="cpu")
    toks = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
    step = make_serve_step(cfg, sample=True, temperature=0.7)
    draws = []
    for _ in range(2):
        _, cache = transformer.prefill(cfg, params, toks, 10)
        gen = torch.Generator().manual_seed(5)
        tok, _ = step(params, cache, {"tokens": toks["tokens"][:, :1]}, gen)
        draws.append(tok)
    assert torch.equal(draws[0], draws[1])
    with pytest.raises(ValueError, match="generator"):
        step(params, cache, {"tokens": toks["tokens"][:, :1]})


def test_unported_families_raise():
    """Every architecture of ``ARCH_IDS`` is served; a family or a
    frontend outside the model zoo raises."""
    for arch in port_configs.ARCH_IDS:
        transformer.check_family(port_configs.get_config(arch))
    rnn = ModelConfig(name="rnn-smoke", family="rnn", num_layers=2,
                      d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                      vocab_size=64)
    with pytest.raises(NotImplementedError, match="no 'rnn' family"):
        transformer.init_params(rnn, device="cpu")
    with pytest.raises(NotImplementedError, match="no 'rnn' family"):
        transformer.init_cache(rnn, 1, 8, device="cpu")
    pixels = dataclasses.replace(port_configs.smoke_config("qwen3-14b"),
                                 frontend="pixels")
    with pytest.raises(NotImplementedError, match="no 'pixels' frontend"):
        transformer.forward(pixels, None, {})


@pytest.mark.parametrize("kernel", ["flash", "ssd", "padded_spmm"])
def test_kernel_wrappers_off_the_cpu_launch_or_raise(kernel):
    """A tensor that is not on the CPU never takes the plain version: on
    a device the kernel cannot run on, the wrapper raises."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        if kernel == "flash":
            q = torch.zeros((2, 8, 16), **meta)
            flash_attention(q, q, q)
        elif kernel == "ssd":
            x = torch.zeros((2, 1, 8, 4), **meta)
            ssd_chunk_scan(x, torch.zeros((2, 1, 8), **meta), x, x)
        else:
            cluster_spmm(torch.zeros(2, dtype=torch.int32, **meta),
                         torch.zeros((2, 8, 16), **meta),
                         torch.zeros((16, 4), **meta), block_r=8,
                         block_k=16, tiles_per_block=1)
