"""Model zoo assembly for the port: the dense, moe, audio and vlm
decoder LMs (attention + SwiGLU or MoE blocks), the ssm (mamba2) and the
hybrid (zamba2) ones.

The counterpart of the JAX package's ``models/transformer.py``, with the
same functional names:

* ``init_params`` — random weights from a seeded :class:`torch.Generator`,
  as a tree of :class:`~repro_torch.models.layers.ParamGroup` modules:
  one per layer (``params["layers"][i]``: ``attn`` + ``mlp`` or ``attn``
  + ``moe`` groups, or one Mamba2 block), the hybrid family's shared
  attention block (``params["shared_attn"]["attn"]`` / ``["mlp"]``), the
  embedding (absent for the ``embeddings`` frontend), the final norm and
  the LM head (absent with ``tie_embeddings``);
* ``forward`` — the full-sequence pass (chunked attention, chunked SSD
  scan; ``use_pallas=True`` routes them to the flash-attention and fused
  SSD kernels, for inference only), rematerialised per layer while
  autograd records; ``loss_fn`` — its mean cross-entropy;
* ``init_cache`` / ``decode_step`` — single-token serving against the KV
  cache (attention) and the O(1) recurrent state (SSM);
* ``prefill`` — the full-sequence pass that also fills the serving cache.

The audio and vlm frontends are stubs, as in the reference: the batch
carries precomputed ``embeddings`` (B, S, D) in place of ``tokens``, and
the vlm family's M-RoPE takes ``positions3`` (3, B, S). The layers run as
a Python loop (no scan); ``prefill`` and ``decode_step`` run under
:func:`torch.inference_mode`. The reference's sharding hints have no
one-card meaning and are left out. ``decode_step`` updates the cache's
tensors in place and returns the same dict; past the cache's end it
writes the last slot, as the reference's ``dynamic_update_slice`` clamps
its start.
"""
from __future__ import annotations

import functools
import itertools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.layers import (ParamGroup, apply_rope, m_rope_cos_sin,
                                       normal_init, rmsnorm, rope_cos_sin,
                                       softmax_cross_entropy, swiglu)
from repro_torch.models.mamba2 import (init_mamba2_params, mamba2_block,
                                       mamba2_decode_block)
from repro_torch.models.moe import init_moe_params, moe_ffn

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill", "check_family"]

FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")
FRONTENDS = ("tokens", "embeddings")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the model zoo's families and
    frontends."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no {cfg.family!r} family in the model zoo "
            f"(families: {', '.join(FAMILIES)})")
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: no {cfg.frontend!r} frontend (frontends: "
            f"{', '.join(FRONTENDS)})")


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
    members: dict = {}
    if cfg.frontend == "tokens":
        members["embed"] = normal_init((cfg.padded_vocab, cfg.d_model),
                                       cfg.d_model ** -0.5, gen, **kw)
    if cfg.family in ("ssm", "hybrid"):
        layers = (init_mamba2_params(cfg, gen, **kw)
                  for _ in range(cfg.num_layers))
    elif cfg.family == "moe":
        layers = (ParamGroup(attn=_init_attn(cfg, gen, kw),
                             moe=init_moe_params(cfg, gen, **kw))
                  for _ in range(cfg.num_layers))
    else:
        layers = (ParamGroup(attn=_init_attn(cfg, gen, kw),
                             mlp=_init_mlp(cfg, gen, kw))
                  for _ in range(cfg.num_layers))
    members["layers"] = nn.ModuleList(layers)
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


def _positions(batch, bsz, seq, device):
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(seq, device=device)[None].expand(bsz, seq)


def _rope_tables(cfg, batch, positions):
    if cfg.m_rope:
        pos3 = batch.get("positions3")
        if pos3 is None:
            pos3 = positions[None].expand(3, *positions.shape)
        return m_rope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta,
                              cfg.m_rope_sections)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _embed_in(cfg, params, batch):
    if cfg.frontend == "tokens":
        return params["embed"][batch["tokens"]]
    return batch["embeddings"]


def _head_out(cfg, params, x):
    """Logits over the *padded* vocab (pad ids masked to -1e30)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _ffn(cfg, lp, h):
    """The block's feed-forward half: the MoE layer or the SwiGLU MLP."""
    if cfg.family == "moe":
        return moe_ffn(cfg, lp["moe"], rmsnorm(h, lp["moe"]["ln"],
                                               cfg.norm_eps))
    return _mlp_full(cfg, lp["mlp"], h)


def _ssm_layer(cfg, lp, h, collect_kv, use_pallas):
    out = mamba2_block(cfg, lp, rmsnorm(h, lp["ln"], cfg.norm_eps),
                       return_state=collect_kv, use_pallas=use_pallas)
    if collect_kv:
        y, st = out
        return h + y, st
    return h + out, None


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _remat(fn, on: bool):
    """``fn`` with its activations recomputed in the backward pass (the
    reference's ``jax.checkpoint``) when ``on``; ``fn`` itself otherwise."""
    if not on:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def forward(cfg: ModelConfig, params: ParamGroup, batch: dict, *,
            remat: bool = True, use_pallas: bool = False,
            collect_kv: bool = False):
    """Full-sequence pass → logits (B, S, V). With ``collect_kv`` also
    returns the per-layer serving state (for prefill).

    While autograd records (grad mode on and a parameter or input that
    requires grad), ``remat`` recomputes activations in the backward pass
    at the reference's points: each layer (dense, moe, audio, vlm), each
    Mamba2 layer (ssm), and each Mamba2 layer nested in each group of
    layers and its shared attention block (hybrid). ``use_pallas=True``
    is refused there: the kernels have no backward, as the reference
    defines no gradient for its Pallas kernels."""
    check_family(cfg)
    recording = torch.is_grad_enabled() and any(
        t.requires_grad for t in itertools.chain(
            params.parameters(), (v for v in batch.values()
                                  if isinstance(v, torch.Tensor))))
    if use_pallas and recording:
        raise NotImplementedError(
            "use_pallas=True under autograd: the flash-attention and SSD "
            "chunk-scan kernels have no backward (the reference defines no "
            "gradient for its Pallas kernels); train with use_pallas=False")
    rm = remat and recording
    x = _embed_in(cfg, params, batch)
    bsz, seq = x.shape[:2]
    states, ks, vs = [], [], []

    def ssm(h, lp):
        return _ssm_layer(cfg, lp, h, collect_kv, use_pallas)

    ssm_fn = _remat(ssm, rm)

    def attn_layer(h, lp, cos, sin):
        a, kv = _attn_full(cfg, lp["attn"], h, cos, sin, use_pallas)
        h = h + a
        return h + _ffn(cfg, lp, h), kv

    def group(h, layers, shared, cos, sin):
        # the shared attention block after every k SSM blocks
        sts = []
        for lp in layers:
            h, st = ssm_fn(h, lp)
            sts.append(st)
        a, kv = _attn_full(cfg, shared["attn"], h, cos, sin, use_pallas)
        h = h + a
        return h + _mlp_full(cfg, shared["mlp"], h), kv, sts

    if cfg.family == "ssm":
        for lp in params["layers"]:
            x, st = ssm_fn(x, lp)
            if collect_kv:
                states.append(st)
    else:
        positions = _positions(batch, bsz, seq, x.device)
        cos, sin = _rope_tables(cfg, batch, positions)
        if cfg.family == "hybrid":
            every = cfg.hybrid_attn_every
            group_fn = _remat(group, rm)
            for gi in range(cfg.num_layers // every):
                layers = params["layers"][gi * every: (gi + 1) * every]
                x, kv, sts = group_fn(x, layers, params["shared_attn"],
                                      cos, sin)
                if collect_kv:
                    states.extend(sts)
                    ks.append(kv[0])
                    vs.append(kv[1])
        else:
            layer_fn = _remat(attn_layer, rm)
            for lp in params["layers"]:
                x, kv = layer_fn(x, lp, cos, sin)
                if collect_kv:
                    ks.append(kv[0])
                    vs.append(kv[1])

    if not collect_kv:
        return _head_out(cfg, params, x)
    # the serving state is stacked (and the per-layer lists freed) before
    # the logits are made, so the two never coexist with the lists
    ck = {}
    if states:
        ck["ssm_state"] = torch.stack([st[0] for st in states])
        ck["conv_buf"] = torch.stack([st[1] for st in states])
    if ks:
        ck["k"] = torch.stack(ks)
        ck["v"] = torch.stack(vs)
    del states, ks, vs
    return _head_out(cfg, params, x), ck


def loss_fn(cfg: ModelConfig, params: ParamGroup, batch: dict, *,
            remat: bool = True, use_pallas: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``forward``'s logits against
    ``batch["labels"]`` (a 0-d fp32 tensor)."""
    logits = forward(cfg, params, batch, remat=remat, use_pallas=use_pallas)
    return softmax_cross_entropy(logits, batch["labels"])


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
    if cfg.family in ("ssm", "hybrid"):
        h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
        cch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        cache["ssm_state"] = torch.zeros(
            (cfg.num_layers, batch_size, h, p, n), dtype=torch.float32,
            device=dev)
        cache["conv_buf"] = torch.zeros(
            (cfg.num_layers, batch_size, cfg.ssm_conv_width - 1, cch),
            dtype=dtype, device=dev)
    return cache


def _attn_decode(cfg, p, x, kc, vc, pos, cos, sin):
    """x (B,1,D); kc/vc (B,Smax,Hkv,Dh), written in place at ``pos`` —
    at the last slot once ``pos`` is past the end, where the reference's
    ``dynamic_update_slice`` clamps its start index."""
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = min(pos, kc.shape[1] - 1)
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, pos)
    return out.reshape(*x.shape[:2], -1) @ p["wo"]


def decode_step(cfg: ModelConfig, params: ParamGroup, batch: dict,
                cache: dict):
    """One-token step. batch: {"tokens": (B,1)} or {"embeddings":
    (B,1,D)} (+ optional ``positions3`` (3,B,1)). Returns (logits
    (B,1,V), cache) — the cache's tensors updated in place, ``pos``
    advanced."""
    check_family(cfg)
    with torch.inference_mode():
        x = _embed_in(cfg, params, batch)
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
            cos, sin = _rope_tables(cfg, batch, positions)
            if cfg.family == "hybrid":
                every = cfg.hybrid_attn_every
                shared = params["shared_attn"]
                for gi in range(cfg.num_layers // every):
                    for li in range(gi * every, (gi + 1) * every):
                        x = ssm(x, li)
                    x = x + _attn_decode(cfg, shared["attn"], x,
                                         cache["k"][gi], cache["v"][gi], pos,
                                         cos, sin)
                    x = x + _mlp_full(cfg, shared["mlp"], x)
            else:
                for li, lp in enumerate(params["layers"]):
                    x = x + _attn_decode(cfg, lp["attn"], x, cache["k"][li],
                                         cache["v"][li], pos, cos, sin)
                    x = x + _ffn(cfg, lp, x)

        logits = _head_out(cfg, params, x)
        cache["pos"] = pos + 1
        return logits, cache


def prefill(cfg: ModelConfig, params: ParamGroup, batch: dict, max_len: int,
            *, use_pallas: bool = False):
    """Run the full prompt, returning (logits, cache ready at pos=seq):
    one chunked forward pass whose attention K/V fill the cache's head,
    and whose SSM layers hand their final SSD state and conv tail
    straight to the cache. The cache takes the parameters' dtype."""
    lead = (batch["tokens"] if cfg.frontend == "tokens"
            else batch["embeddings"])
    bsz, seq = lead.shape[:2]
    norm = params["final_norm"]
    cache = init_cache(cfg, bsz, max_len, dtype=norm.dtype,
                       device=norm.device)
    with torch.inference_mode():
        logits, ck = forward(cfg, params, batch, use_pallas=use_pallas,
                             collect_kv=True)
        if cfg.num_attn_layers:
            cache["k"][:, :, :seq] = ck.pop("k").to(cache["k"].dtype)
            cache["v"][:, :, :seq] = ck.pop("v").to(cache["v"].dtype)
        if cfg.family in ("ssm", "hybrid"):
            cache["ssm_state"].copy_(ck["ssm_state"])
            cache["conv_buf"].copy_(ck["conv_buf"])
    cache["pos"] = seq
    return logits, cache
