"""The port's LM zoo — the dense, moe, audio and vlm families — against
the JAX package, on the CPU.

Seeded numpy inputs go through both packages with the JAX package's
parameters carried across by ``lm_params_from_numpy``: M-RoPE's cos/sin
tables, ``moe_ffn`` (with capacity drops and dropless), and ``forward`` /
``prefill`` (logits and every cache field) plus four decode steps of the
eight architectures' smoke configs, and ``run_serving`` on the two
``embeddings`` architectures. The JAX models run with
``use_pallas=False`` (their flash path cannot run on the CPU); the port
runs both its chunked path and ``use_pallas=True`` (on the CPU, the
flash-attention kernel's plain version).

Tolerances: model logits and cache fields within 1e-4 absolute + 1e-4
relative, as ``tests/test_torch_lm.py`` holds the hybrid and ssm
families (observed ≤ 5e-6 on logits of magnitude ≈ 4); M-RoPE tables
within 2e-6 (fp32 cos/sin of the same angles); ``moe_ffn`` within 1e-5
(fp32 products summed in another order), with the same dropped pairs.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import base as port_configs
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers, moe, transformer
from torch_port_helpers import lm_params_pair

ZOO = ("musicgen-large", "llama3-405b", "qwen3-14b", "granite-34b",
       "command-r-35b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
       "qwen2-vl-72b")
MOE = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
LOGIT_RTOL = LOGIT_ATOL = 1e-4
MAX_LEN = 40


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def _positions3(bsz, seq, start=0):
    """Three position streams that differ: time, a slow row and a fast
    column index (as an image's patches would give)."""
    t = start + np.arange(seq)
    return np.stack([np.broadcast_to(t, (bsz, seq)),
                     np.broadcast_to(t // 3, (bsz, seq)),
                     np.broadcast_to(t % 5, (bsz, seq))]).astype(np.int32)


def _batch(cfg, bsz, seq, rng, start=0):
    """One (reference, port) batch pair of ``seq`` positions: tokens, or
    embeddings (with M-RoPE's positions3 for vlm)."""
    if cfg.frontend == "tokens":
        toks = rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(np.int32)
        return {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    emb = rng.standard_normal((bsz, seq, cfg.d_model)).astype(np.float32)
    ref, port = {"embeddings": jnp.asarray(emb)}, {"embeddings": _t(emb)}
    if cfg.m_rope:
        p3 = _positions3(bsz, seq, start)
        ref["positions3"] = jnp.asarray(p3)
        port["positions3"] = _t(p3).long()
    return ref, port


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_params_carry_into_the_init_params_layout(arch):
    """The carried tree and the port's own ``init_params`` have the same
    members and shapes (no ``embed`` for the embeddings frontend, no
    ``lm_head`` with tied embeddings) and the reference's leaf count."""
    rcfg, rparams, cfg, loaded = lm_params_pair(arch)
    fresh = transformer.init_params(cfg, 0, device="cpu")
    got = {k: tuple(v.shape) for k, v in loaded.named_parameters()}
    want = {k: tuple(v.shape) for k, v in fresh.named_parameters()}
    assert got == want
    assert ("embed" in want) == (cfg.frontend == "tokens")
    assert ("lm_head" in want) == (not cfg.tie_embeddings)
    assert sum(v.numel() for v in fresh.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(rparams))


def test_published_sizes_of_the_card_models():
    """The four architectures the card runs, by their tensors (padded
    vocabulary and experts included) and their attention shapes."""
    def tensors(cfg):
        d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
        hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        attn = 2 * d * hq + 2 * d * hkv + d + (2 * hd if cfg.qk_norm else 0)
        if cfg.family == "moe":
            e = cfg.num_experts_padded
            ffn = d * e + 3 * e * d * f + d
        else:
            ffn = 3 * d * f + d
        head = 0 if cfg.tie_embeddings else cfg.padded_vocab * d
        embed = cfg.padded_vocab * d if cfg.frontend == "tokens" else 0
        return cfg.num_layers * (attn + ffn) + d + head + embed

    get = port_configs.get_config
    qwen3, granite = get("qwen3-14b"), get("granite-moe-3b-a800m")
    musicgen = get("musicgen-large")
    vlm4 = dataclasses.replace(get("qwen2-vl-72b"), num_layers=4)
    assert tensors(qwen3) == 14_769_617_920
    assert tensors(granite) == 3_979_445_760
    assert tensors(musicgen) == musicgen.param_count() == 3_225_618_432
    assert tensors(vlm4) == vlm4.param_count() == 4_756_414_464
    # (query heads per KV head, head_dim) of K10's launches on the card
    assert [(c.num_heads // c.num_kv_heads, c.head_dim)
            for c in (qwen3, granite, musicgen, vlm4)] == [
        (5, 128), (3, 64), (1, 64), (8, 128)]
    assert moe.moe_capacity(granite, 1024) == 214


@pytest.mark.parametrize("head_dim,sections", [(16, (2, 3, 3)),
                                               (128, (16, 24, 24))])
def test_m_rope_matches_the_reference(head_dim, sections):
    """Three position streams that differ, so each band must take its own
    section's stream; and one stream broadcast, where M-RoPE is RoPE."""
    p3 = _positions3(2, 11, start=3)
    cos, sin = layers.m_rope_cos_sin(_t(p3), head_dim, 1e6, sections)
    rc, rs = ref_layers.m_rope_cos_sin(jnp.asarray(p3), head_dim, 1e6,
                                       sections)
    assert cos.shape == (2, 11, head_dim // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rc), atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rs), atol=2e-6)
    same = np.broadcast_to(p3[:1], p3.shape)
    cos1, sin1 = layers.m_rope_cos_sin(_t(same), head_dim, 1e6, sections)
    c0, s0 = layers.rope_cos_sin(_t(same[0]), head_dim, 1e6)
    assert torch.equal(cos1, c0) and torch.equal(sin1, s0)
    with pytest.raises(ValueError, match="sections"):
        layers.m_rope_cos_sin(_t(p3), head_dim + 2, 1e6, sections)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _reference_dropped(rcfg, rp, x):
    """The reference's dropped (token, slot) pairs, by its own algorithm
    in numpy: its top-k of its router logits, a stable sort by expert,
    each pair's rank in its expert against the capacity."""
    bsz, s, _ = x.shape
    e, k = rcfg.num_experts_padded, rcfg.experts_per_token
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), rp["router"])
    if e != rcfg.num_experts:
        logits = jnp.where(jnp.arange(e) >= rcfg.num_experts, -jnp.inf,
                           logits)
    flat_e = np.asarray(jax.lax.top_k(logits, k)[1]).reshape(bsz, s * k)
    cap = max(8, int(s * k / e * rcfg.moe_capacity_factor) + 1)
    dropped = np.zeros((bsz, s * k), bool)
    for b in range(bsz):
        order = np.argsort(flat_e[b], kind="stable")
        seen = np.zeros(e, int)
        for i in order:
            dropped[b, i] = seen[flat_e[b, i]] >= cap
            seen[flat_e[b, i]] += 1
    return dropped.reshape(bsz, s, k)


@pytest.mark.parametrize("capacity", [1.25, 64.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_the_reference(arch, capacity):
    """At capacity 1.25 on 96 tokens some pairs overflow their expert and
    are dropped — the same pairs in both packages, and more than one
    expert overflows; at 64 none are."""
    rcfg, rparams, cfg, params = lm_params_pair(arch)
    rcfg = dataclasses.replace(rcfg, moe_capacity_factor=capacity)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["moe"])
    p = params["layers"][0]["moe"]
    # tokens that share a component (as neighbouring tokens do) crowd
    # the same experts
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 1, cfg.d_model))
         + 0.7 * rng.standard_normal((2, 96, cfg.d_model))).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: ref_moe.moe_ffn(rcfg, p, x))(
        rp, jnp.asarray(x)))
    dropped_shape = (*x.shape[:2], cfg.experts_per_token)
    with torch.inference_mode():
        got = moe.moe_ffn(cfg, p, _t(x)).numpy()
        r = moe.moe_route(cfg, p, _t(x))
        # back from sorted order to pair t·k + j
        dropped = torch.empty_like(r["keep"]).scatter_(
            1, r["order"], ~r["keep"]).reshape(dropped_shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref_dropped = _reference_dropped(rcfg, rp, x)
    assert np.array_equal(dropped, ref_dropped)
    if capacity < 2:
        assert dropped.sum() > 1
    else:
        assert not dropped.any()


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_serving(arch):
    rcfg = ref_configs.smoke_config(arch)
    return (jax.jit(lambda p, b: ref_tf.prefill(rcfg, p, b, MAX_LEN)),
            jax.jit(lambda p, b, c: ref_tf.decode_step(rcfg, p, b, c)))


@pytest.mark.parametrize("arch", ZOO)
def test_family_matches_the_reference(arch):
    """forward and prefill (logits and every cache field) of a 24-position
    prompt against the reference's prefill, on the port's chunked path and
    its kernel path; then four decode steps from each cache (greedy
    tokens, or fresh embeddings with M-RoPE positions past the prompt)."""
    _, rparams, cfg, params = lm_params_pair(arch)
    ref_prefill, ref_step = _ref_serving(arch)
    rng = np.random.default_rng(len(arch))
    seq = 24
    rbatch, pbatch = _batch(cfg, 2, seq, rng)
    rlogits, rcache0 = ref_prefill(rparams, rbatch)
    rlogits = np.asarray(rlogits)
    fwd = transformer.forward(cfg, params, pbatch)
    _close(fwd.numpy(), rlogits)
    steps = [_batch(cfg, 2, 1, rng, start=seq + i) for i in range(4)]
    for use_pallas in (False, True):
        logits, cache = transformer.prefill(cfg, params, pbatch, MAX_LEN,
                                            use_pallas=use_pallas)
        _close(logits.numpy(), rlogits)
        assert cache["pos"] == int(rcache0["pos"]) == seq
        assert set(cache) == set(rcache0)
        for key in set(rcache0) - {"pos"}:
            assert cache[key].dtype == torch.float32
            _close(cache[key].numpy(), np.asarray(rcache0[key]))
        rcache = rcache0
        tok = rlogits[:, -1].argmax(-1)[:, None].astype(np.int32)
        for rstep, pstep in steps:
            if cfg.frontend == "tokens":
                rstep, pstep = ({"tokens": jnp.asarray(tok)},
                                {"tokens": _t(tok).long()})
            got, cache = transformer.decode_step(cfg, params, pstep, cache)
            want, rcache = ref_step(rparams, rstep, rcache)
            got, want = got.numpy(), np.asarray(want)
            _close(got, want)
            tok = want[:, -1].argmax(-1)[:, None].astype(np.int32)
        assert cache["pos"] == seq + 4
        for key in set(rcache) - {"pos"}:
            _close(cache[key].numpy(), np.asarray(rcache[key]))


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b"])
def test_run_serving_on_embeddings_matches_the_reference(arch, monkeypatch):
    """``run_serving`` draws the prompt's embeddings and then one (B, 1, D)
    draw per decode step from the seed's numpy generator, as the
    reference does: with the reference's weights carried in, both give
    the same greedy tokens."""
    _, rparams, cfg, params = lm_params_pair(arch)
    # seed 0: the reference's own init_params(PRNGKey(0)), as carried
    want = ref_serve.run_serving(arch, batch=2, prompt_len=16, gen=5,
                                 seed=0)["tokens"]
    monkeypatch.setattr(port_serve, "init_params",
                        lambda *a, **kw: params)
    for use_pallas in (False, True):
        got = port_serve.run_serving(arch, batch=2, prompt_len=16, gen=5,
                                     seed=0, device="cpu",
                                     use_pallas=use_pallas)["tokens"]
        assert got.shape == (2, 5)
        assert np.array_equal(got, want)


def test_run_serving_takes_a_config_cut_in_depth():
    """A :class:`ModelConfig` is served as given (the card's qwen2-vl
    run cuts the published config's depth)."""
    cfg = dataclasses.replace(port_configs.smoke_config("qwen2-vl-72b"),
                              num_layers=1)
    out = port_serve.run_serving(cfg, batch=2, prompt_len=8, gen=3,
                                 device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert (out["tokens"] < cfg.vocab_size).all()


@pytest.mark.parametrize("arch", ZOO)
def test_cli_serves_the_smoke_config(arch, capsys):
    port_serve.main(["--arch", arch, "--device", "cpu", "--gen", "3"])
    assert capsys.readouterr().out.startswith("[serve] prefill")
