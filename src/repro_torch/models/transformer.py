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
:func:`torch.inference_mode` (:func:`torch.no_grad` for DTensor
parameters). ``decode_step`` updates the cache's
tensors in place and returns the same dict; past the cache's end it
writes the last slot, as the reference's ``dynamic_update_slice`` clamps
its start.

The reference's sharding hints sit at the same places
(:func:`~repro_torch.distributed.sharding.constrain`): no-ops on plain
tensors, and redistributions when the parameters and batch are DTensors
under active :class:`~repro_torch.distributed.sharding.Rules` (run those
under :func:`~torch.distributed.tensor.experimental.implicit_replication`).
Attention runs on each rank's shards with its heads split over ``model``
where the KV heads divide it, and whole heads otherwise.
"""
from __future__ import annotations

import functools
import itertools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (active_rules, constrain,
                                              constrain_if_fsdp, is_dtensor,
                                              local_apply,
                                              local_shape_offset, pin_grad,
                                              placements,
                                              spec_from_placements, use_rules)
from repro_torch.models.attention import (combine_decode_partials,
                                         decode_attention,
                                         decode_attention_partial,
                                         gqa_attention)
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


def _split_heads(x, heads: int, hd: int):
    """(B, S, heads·hd) → (B, S, heads, hd). Under sharding rules the
    projection is first laid out by whole heads (over ``model`` where it
    divides them, replicated otherwise): DTensor splits no shard across a
    head."""
    r = active_rules()
    if r is not None and is_dtensor(x):
        x = constrain(x, "data", None, r.over_model(heads))
    return x.reshape(*x.shape[:2], heads, hd)


def _qkv(cfg, p, h):
    hd = cfg.head_dim
    q = _split_heads(h @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(h @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(h @ p["wv"], cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _head_spec(cfg) -> tuple:
    """The layout in which attention runs on each rank's shards: (B, S,
    H, D) with the batch over the data axes and the heads over ``model``
    when the KV heads divide it (each rank's query heads then meet their
    own KV heads), whole heads otherwise."""
    r = active_rules()
    hax = r.over_model(cfg.num_kv_heads) if r is not None else None
    return ("data", None, hax, None)


def _attn_full(cfg, p, x, cos, sin, use_pallas):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    hs = _head_spec(cfg)
    out = local_apply(
        lambda q, k, v: gqa_attention(q, k, v, causal=True,
                                      use_pallas=use_pallas),
        (q, k, v), (hs, hs, hs), (hs, q.shape))
    # the merged heads' gradient keeps whole heads per shard
    out = pin_grad(out.reshape(*x.shape[:2], -1), *hs[:3])
    out = out @ p["wo"]
    # the reference pins this under FSDP only; DTensor needs it always:
    # left to its cost model, the residual add sequence-shards the stream
    # ahead of the MLP's products, whose strided layout then takes it a
    # minute per product to plan
    out = constrain(out, "data", None, None)
    return out, (k, v)


def _mlp_full(cfg, p, x):
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    # under ZeRO-3 weights, pin the SwiGLU hidden's TP layout and the
    # batch-sharded output (the reference's FSDP-only pins)
    return swiglu(h, p["wg"], p["wu"], p["wd"], pin=constrain_if_fsdp)


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
        x = _lookup(params["embed"], batch["tokens"])
    else:
        x = batch["embeddings"]
    return constrain(x, "data", None, None)


def _lookup(table, tokens):
    """``table[tokens]``. Under sharding rules a vocab-parallel lookup:
    each rank looks up the tokens of its batch rows that fall in its
    vocabulary shard (zeros elsewhere), a result partial over ``model``
    that the caller's constraint sums (DTensor's own lookup leaves a
    masked-partial result whose gradient cannot meet a partial one)."""
    r = active_rules()
    if r is None or not is_dtensor(table):
        return table[tokens]
    start = local_shape_offset(table.shape, table.device_mesh,
                               table.placements)[1][0]

    def shard_lookup(tokens, table):
        ids = tokens.long() - start
        hit = (ids >= 0) & (ids < table.shape[0])
        x = F.embedding(torch.where(hit, ids, 0), table)
        return x * hit[..., None].to(x.dtype)

    return local_apply(
        shard_lookup, (tokens, table),
        (("data", None), (r.model_axis, None)),
        (("data", None, None), (*tokens.shape, table.shape[1]),
         (r.model_axis,)))


def _head_out(cfg, params, x):
    """Logits over the *padded* vocab (pad ids masked to -1e30)."""
    x = constrain(x, "data", None, None)   # SP gather, as at each layer
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size and is_dtensor(logits):
        # out of place, as the reference: a sharded tensor takes no
        # in-place slice fill
        pad = torch.arange(cfg.padded_vocab,
                           device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=logits.device), logits)
    elif cfg.padded_vocab != cfg.vocab_size:
        # in place: no second full-vocabulary tensor
        logits[..., cfg.vocab_size:] = -1e30
    return constrain(logits, "data", None, "model")


def _ffn(cfg, lp, h):
    """The block's feed-forward half: the MoE layer or the SwiGLU MLP."""
    if cfg.family == "moe":
        return moe_ffn(cfg, lp["moe"], rmsnorm(h, lp["moe"]["ln"],
                                               cfg.norm_eps))
    return _mlp_full(cfg, lp["mlp"], h)


def _ssm_layer(cfg, lp, h, collect_kv, use_pallas):
    h = constrain(h, "data", None, None)   # SP gather (see attn_layer)
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
    reference's ``jax.checkpoint``) when ``on``; ``fn`` itself otherwise.
    The recompute runs under the sharding rules active now: the backward
    pass may run on another thread (the card's), which does not see them
    (``implicit_replication`` is a process-wide flag, which it does)."""
    if not on:
        return fn
    rules = active_rules()
    if rules is None:
        return functools.partial(checkpoint, fn, use_reentrant=False)

    def under_rules(*args):
        with use_rules(rules):
            return fn(*args)

    return functools.partial(checkpoint, under_rules, use_reentrant=False)


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

    def ssm_layer(h, lp):
        h, st = ssm(h, lp)
        return constrain(h, "data", "model", None), st

    ssm_layer_fn = _remat(ssm_layer, rm)

    def attn_layer(h, lp, cos, sin):
        # Megatron-SP: the residual stream is sequence-sharded over
        # `model` between layers; gather the sequence here so the model
        # axis is free for the TP products
        h = constrain(h, "data", None, None)
        a, kv = _attn_full(cfg, lp["attn"], h, cos, sin, use_pallas)
        h = h + a
        h = h + _ffn(cfg, lp, h)
        return constrain(h, "data", "model", None), kv

    def group(h, layers, shared, cos, sin):
        # the shared attention block after every k SSM blocks
        sts = []
        for lp in layers:
            h, st = ssm_fn(h, lp)
            sts.append(st)
        h = constrain(h, "data", None, None)
        a, kv = _attn_full(cfg, shared["attn"], h, cos, sin, use_pallas)
        h = h + a
        h = h + _mlp_full(cfg, shared["mlp"], h)
        return constrain(h, "data", "model", None), kv, sts

    if cfg.family == "ssm":
        for lp in params["layers"]:
            x, st = ssm_layer_fn(x, lp)
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
    _write_slot(kc, slot, k[:, 0])
    _write_slot(vc, slot, v[:, 0])
    if is_dtensor(kc):
        out = _sharded_decode_attention(q, kc, vc, pos)
    else:
        out = decode_attention(q, kc, vc, pos)
    return out.reshape(*x.shape[:2], -1) @ p["wo"]


def _sharded_decode_attention(q, kc, vc, pos):
    """:func:`decode_attention` over a DTensor cache, as flash-decoding:
    each rank attends over its own batch rows, heads and sequence shard,
    and the shards' online-softmax partials are combined."""
    mesh = kc.device_mesh
    bat, seq, kv_ax, _ = spec_from_placements(mesh, kc.placements, 4)
    _, off = local_shape_offset(kc.shape, mesh,
                                                   kc.placements)
    bsz, _, hq, d = q.shape
    hkv = kc.shape[2]
    seq_axes = seq if isinstance(seq, tuple) else (seq,) * (seq is not None)
    n = 1
    for a in seq_axes:
        n *= mesh.size(list(mesh.mesh_dim_names).index(a))
    cache_spec = (bat, seq, kv_ax, None)
    part = ((seq, bat, kv_ax, None, None), (n, bsz, hkv, hq // hkv, 1))
    m, l, acc = local_apply(
        lambda q, kc, vc: decode_attention_partial(q, kc, vc, pos, off[1]),
        (q, kc, vc), ((bat, None, kv_ax, None), cache_spec, cache_spec),
        (part, part, ((seq, bat, kv_ax, None, None),
                      (n, bsz, hkv, hq // hkv, d))))
    return combine_decode_partials(m, l, acc, q.dtype)


def _write_slot(cache_t, slot: int, val):
    """``cache_t[:, slot] = val`` in place: cache_t (B, Smax, Hkv, Dh),
    val (B, Hkv, Dh). A DTensor cache is written on the rank whose shard
    holds ``slot`` (its sequence may be sharded), from ``val`` laid out
    like the cache's other dimensions."""
    if not is_dtensor(cache_t):
        cache_t[:, slot] = val.to(cache_t.dtype)
        return
    mesh = cache_t.device_mesh
    spec = spec_from_placements(mesh, cache_t.placements, 4)
    want = placements(mesh, (spec[0], spec[2], spec[3]))
    if tuple(val.placements) != want:
        val = val.redistribute(mesh, want)
    shape, off = local_shape_offset(
        cache_t.shape, mesh, cache_t.placements)
    if off[1] <= slot < off[1] + shape[1]:
        local = cache_t.to_local()
        local[:, slot - off[1]] = val.to_local().to(local.dtype)


def _no_autograd(params):
    """:func:`torch.inference_mode` — or :func:`torch.no_grad` for DTensor
    parameters, which inference mode does not take."""
    if is_dtensor(params["final_norm"]):
        return torch.no_grad()
    return torch.inference_mode()


def decode_step(cfg: ModelConfig, params: ParamGroup, batch: dict,
                cache: dict):
    """One-token step. batch: {"tokens": (B,1)} or {"embeddings":
    (B,1,D)} (+ optional ``positions3`` (3,B,1)). Returns (logits
    (B,1,V), cache) — the cache's tensors updated in place, ``pos``
    advanced."""
    check_family(cfg)
    with _no_autograd(params):
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
    with _no_autograd(params):
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
