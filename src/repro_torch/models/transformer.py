"""Model zoo assembly for the port: the ``ssm`` (mamba2) and ``hybrid``
(zamba2) decoder LMs.

The counterpart of the JAX package's ``models/transformer.py``, with the
same functional names:

* ``init_params`` — random weights from a seeded :class:`torch.Generator`,
  as a tree of :class:`~repro_torch.models.layers.ParamGroup` modules: one
  per Mamba2 block (``params["layers"][i]``), the hybrid family's shared
  attention block (``params["shared_attn"]["attn"]`` / ``["mlp"]``), the
  embedding, final norm and LM head;
* ``forward`` — the full-sequence pass (chunked attention, chunked SSD
  scan; ``use_pallas=True`` routes them to the flash-attention and fused
  SSD kernels);
* ``init_cache`` / ``decode_step`` — single-token serving against the KV
  cache (attention) and the O(1) recurrent state (SSM);
* ``prefill`` — the full-sequence pass that also fills the serving cache.

The layers run as a Python loop under :func:`torch.inference_mode` (no
scan, no rematerialisation); the reference's sharding hints have no
one-card meaning and are left out. ``decode_step`` updates the cache's
tensors in place and returns the same dict. The ``dense``, ``audio``,
``vlm`` and ``moe`` families raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import (ParamGroup, apply_rope, normal_init,
                                       rmsnorm, rope_cos_sin, swiglu)
from repro_torch.models.mamba2 import (init_mamba2_params, mamba2_block,
                                       mamba2_decode_block)

__all__ = ["init_params", "forward", "init_cache", "decode_step", "prefill",
           "check_family"]

PORTED_FAMILIES = ("ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a configuration the port cannot run yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (the "
            "port runs the ssm and hybrid families; the others wait for "
            "ROADMAP queue 1, item 10 — LM zoo)")
    if cfg.frontend != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend waits for ROADMAP "
            "queue 1, item 10 (LM zoo)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(cfg: ModelConfig, gen, kw) -> ParamGroup:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    sc = d ** -0.5
    members = dict(
        wq=normal_init((d, hq * hd), sc, gen, **kw),
        wk=normal_init((d, hkv * hd), sc, gen, **kw),
        wv=normal_init((d, hkv * hd), sc, gen, **kw),
        wo=normal_init((hq * hd, d), (hq * hd) ** -0.5, gen, **kw),
        ln=torch.zeros((d,), **kw))
    if cfg.qk_norm:
        members["q_norm"] = torch.zeros((hd,), **kw)
        members["k_norm"] = torch.zeros((hd,), **kw)
    return ParamGroup(**members)


def _init_mlp(cfg: ModelConfig, gen, kw) -> ParamGroup:
    d, f = cfg.d_model, cfg.d_ff
    return ParamGroup(
        wg=normal_init((d, f), d ** -0.5, gen, **kw),
        wu=normal_init((d, f), d ** -0.5, gen, **kw),
        wd=normal_init((f, d), f ** -0.5, gen, **kw),
        ln=torch.zeros((d,), **kw))


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0, *,
                device="cuda", dtype=torch.float32) -> ParamGroup:
    """Random weights for ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU). ``generator`` is a :class:`torch.Generator`
    on that device or an int seed for one."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    kw = dict(device=dev, dtype=dtype)
    members: dict = {
        "embed": normal_init((cfg.padded_vocab, cfg.d_model),
                             cfg.d_model ** -0.5, gen, **kw),
        "layers": nn.ModuleList(
            init_mamba2_params(cfg, gen, **kw)
            for _ in range(cfg.num_layers))}
    if cfg.family == "hybrid":
        members["shared_attn"] = ParamGroup(attn=_init_attn(cfg, gen, kw),
                                            mlp=_init_mlp(cfg, gen, kw))
    members["final_norm"] = torch.zeros((cfg.d_model,), **kw)
    if not cfg.tie_embeddings:
        members["lm_head"] = normal_init((cfg.d_model, cfg.padded_vocab),
                                         cfg.d_model ** -0.5, gen, **kw)
    return ParamGroup(**members)


# ---------------------------------------------------------------------------
# shared sub-blocks
# ---------------------------------------------------------------------------


def _qkv(cfg, p, h):
    bsz, s, _ = h.shape
    hd = cfg.head_dim
    q = (h @ p["wq"]).reshape(bsz, s, cfg.num_heads, hd)
    k = (h @ p["wk"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    v = (h @ p["wv"]).reshape(bsz, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_full(cfg, p, x, cos, sin, use_pallas):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = gqa_attention(q, k, v, causal=True, use_pallas=use_pallas)
    out = out.reshape(*x.shape[:2], -1) @ p["wo"]
    return out, (k, v)


def _mlp_full(cfg, p, x):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    return swiglu(h, p["wg"], p["wu"], p["wd"])


def _head_out(cfg, params, x):
    """Logits over the *padded* vocab (pad ids masked to -1e30)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _ssm_layer(cfg, lp, h, collect_kv, use_pallas):
    out = mamba2_block(cfg, lp, rmsnorm(h, lp["ln"], cfg.norm_eps),
                       return_state=collect_kv, use_pallas=use_pallas)
    if collect_kv:
        y, st = out
        return h + y, st
    return h + out, None


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: ParamGroup, batch: dict, *,
            use_pallas: bool = False, collect_kv: bool = False):
    """Full-sequence pass → logits (B, S, V). With ``collect_kv`` also
    returns the per-layer serving state (for prefill)."""
    check_family(cfg)
    with torch.inference_mode():
        tokens = batch["tokens"]
        x = params["embed"][tokens]
        bsz, seq = tokens.shape
        states, bufs, ks, vs = [], [], [], []

        def ssm(h, li):
            h, st = _ssm_layer(cfg, params["layers"][li], h, collect_kv,
                               use_pallas)
            if collect_kv:
                states.append(st[0])
                bufs.append(st[1])
            return h

        if cfg.family == "ssm":
            for li in range(cfg.num_layers):
                x = ssm(x, li)
        else:  # hybrid: the shared attention block after every k SSM blocks
            positions = torch.arange(seq, device=x.device)[None].expand(
                bsz, seq)
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
            every = cfg.hybrid_attn_every
            shared = params["shared_attn"]
            for gi in range(cfg.num_layers // every):
                for li in range(gi * every, (gi + 1) * every):
                    x = ssm(x, li)
                a, (k, v) = _attn_full(cfg, shared["attn"], x, cos, sin,
                                       use_pallas)
                x = x + a
                x = x + _mlp_full(cfg, shared["mlp"], x)
                if collect_kv:
                    ks.append(k)
                    vs.append(v)

        logits = _head_out(cfg, params, x)
        if not collect_kv:
            return logits
        ck = {"ssm_state": torch.stack(states), "conv_buf": torch.stack(bufs)}
        if ks:
            ck["k"] = torch.stack(ks)
            ck["v"] = torch.stack(vs)
        return logits, ck


# ---------------------------------------------------------------------------
# serving: cache init + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.float32, *, device="cuda") -> dict:
    check_family(cfg)
    dev = resolve_device(device)
    cache: dict = {"pos": 0}
    na = cfg.num_attn_layers
    if na:
        cache["k"] = torch.zeros((na, batch_size, max_len, cfg.num_kv_heads,
                                  cfg.head_dim), dtype=dtype, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    cch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    cache["ssm_state"] = torch.zeros((cfg.num_layers, batch_size, h, p, n),
                                     dtype=torch.float32, device=dev)
    cache["conv_buf"] = torch.zeros(
        (cfg.num_layers, batch_size, cfg.ssm_conv_width - 1, cch),
        dtype=dtype, device=dev)
    return cache


def _attn_decode(cfg, p, x, kc, vc, pos, cos, sin):
    """x (B,1,D); kc/vc (B,Smax,Hkv,Dh), written at ``pos`` in place."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kc[:, pos] = k[:, 0].to(kc.dtype)
    vc[:, pos] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, pos)
    return out.reshape(*x.shape[:2], -1) @ p["wo"]


def decode_step(cfg: ModelConfig, params: ParamGroup, batch: dict,
                cache: dict):
    """One-token step. batch: {"tokens": (B,1)}. Returns (logits (B,1,V),
    cache) — the cache's tensors updated in place, ``pos`` advanced."""
    check_family(cfg)
    with torch.inference_mode():
        x = params["embed"][batch["tokens"]]
        pos = int(cache["pos"])
        bsz = x.shape[0]

        def ssm(h, li):
            lp = params["layers"][li]
            y, st, buf = mamba2_decode_block(
                cfg, lp, rmsnorm(h, lp["ln"], cfg.norm_eps),
                cache["ssm_state"][li], cache["conv_buf"][li])
            cache["ssm_state"][li] = st
            cache["conv_buf"][li] = buf
            return h + y

        if cfg.family == "ssm":
            for li in range(cfg.num_layers):
                x = ssm(x, li)
        else:
            positions = torch.full((bsz, 1), pos, device=x.device)
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
            every = cfg.hybrid_attn_every
            shared = params["shared_attn"]
            for gi in range(cfg.num_layers // every):
                for li in range(gi * every, (gi + 1) * every):
                    x = ssm(x, li)
                x = x + _attn_decode(cfg, shared["attn"], x, cache["k"][gi],
                                     cache["v"][gi], pos, cos, sin)
                x = x + _mlp_full(cfg, shared["mlp"], x)

        logits = _head_out(cfg, params, x)
        cache["pos"] = pos + 1
        return logits, cache


def prefill(cfg: ModelConfig, params: ParamGroup, batch: dict, max_len: int,
            *, use_pallas: bool = False):
    """Run the full prompt, returning (logits, cache ready at pos=seq):
    one chunked forward pass whose SSM layers hand their final SSD state
    and conv tail straight to the cache, and whose attention K/V fill the
    cache's head."""
    bsz, seq = batch["tokens"].shape
    cache = init_cache(cfg, bsz, max_len, dtype=params["embed"].dtype,
                       device=params["embed"].device)
    logits, ck = forward(cfg, params, batch, use_pallas=use_pallas,
                         collect_kv=True)
    with torch.inference_mode():
        if cfg.num_attn_layers:
            cache["k"][:, :, :seq] = ck["k"].to(cache["k"].dtype)
            cache["v"][:, :, :seq] = ck["v"].to(cache["v"].dtype)
        cache["ssm_state"].copy_(ck["ssm_state"])
        cache["conv_buf"].copy_(ck["conv_buf"])
    cache["pos"] = seq
    return logits, cache
