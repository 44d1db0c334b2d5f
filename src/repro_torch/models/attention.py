"""Attention: chunked (flash-style, plain torch) causal attention for
prefill and cached single-token attention for decode.

The counterpart of the JAX package's ``models/attention.py``. The chunked
path walks query blocks (outer) and KV blocks (inner) with an
online-softmax accumulator, bounding live memory to
O(q_chunk × kv_chunk) per (batch, head); ``use_pallas=True`` sends the
whole product to the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_mha`) instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import flash_mha

__all__ = ["gqa_attention", "decode_attention", "decode_attention_partial",
           "combine_decode_partials"]

NEG_INF = -1e30


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_chunk: int = 256,
                  kv_chunk: int = 1024, use_pallas: bool = False
                  ) -> torch.Tensor:
    """q (B,S,Hq,D), k/v (B,S,Hkv,D) → (B,S,Hq,D)."""
    bsz, s, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv

    if use_pallas:
        out = flash_mha(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
                        causal=causal)
        return out.movedim(1, 2)

    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:     # odd length: plain masked attention
        return _full_attention(q, k, v, causal=causal)

    scale = 1.0 / (d ** 0.5)
    nq, nk = s // q_chunk, s // kv_chunk
    qr = q.reshape(bsz, nq, q_chunk, hkv, groups, d)
    kr = k.reshape(bsz, nk, kv_chunk, hkv, d)
    vr = v.reshape(bsz, nk, kv_chunk, hkv, d)

    chunks = []
    for qi in range(nq):
        qb = qr[:, qi] * scale                       # (B, qc, Hkv, G, D)
        m = torch.full((bsz, hkv, groups, q_chunk, 1), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((bsz, hkv, groups, q_chunk, d),
                          dtype=torch.float32, device=q.device)
        for ki in range(nk):
            kb = kr[:, ki]                           # (B, kc, Hkv, D)
            vb = vr[:, ki]
            s_blk = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float())
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                kpos = ki * kv_chunk + torch.arange(kv_chunk,
                                                    device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s_blk = torch.where(mask[None, None, None], s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1, keepdim=True))
            p = torch.exp(s_blk - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)
        # (B, Hkv, G, qc, D) -> (B, qc, Hkv, G, D)
        chunks.append(out.movedim(3, 1).to(q.dtype))
    out = torch.cat(chunks, dim=1)                   # (B, S, Hkv, G, D)
    return out.reshape(bsz, s, hq, d)


def _full_attention(q, k, v, *, causal):
    bsz, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qr = q.reshape(bsz, s, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(),
                          k.float()) / (d ** 0.5)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(bsz, s, hq, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One-token attention against a cache.

    q (B,1,Hq,D); caches (B,Smax,Hkv,D); positions > pos are masked.
    """
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qr = q.reshape(bsz, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                          k_cache.float()) / (d ** 0.5)
    idx = torch.arange(k_cache.shape[1], device=q.device)
    logits = torch.where(idx[None, None, None] <= pos, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(bsz, 1, hq, d)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: int, offset: int):
    """One shard's part of :func:`decode_attention` when the cache's
    sequence is split: the cache holds positions ``offset ..`` of the
    whole. Returns the online-softmax partials (running max ``m`` and sum
    ``l`` (1, B, Hkv, G, 1), unnormalised output ``acc`` (1, B, Hkv, G,
    D)), all zero where the shard holds no position ≤ ``pos``."""
    bsz, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    qr = q.reshape(bsz, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                          k_cache.float()) / (d ** 0.5)
    idx = offset + torch.arange(k_cache.shape[1], device=q.device)
    live = idx[None, None, None] <= pos
    logits = torch.where(live, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(logits - m), 0.0)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return m[None], p.sum(dim=-1, keepdim=True)[None], acc[None]


def combine_decode_partials(m, l, acc, dtype) -> torch.Tensor:
    """The shards' partials (leading shard axis) combined into
    :func:`decode_attention`'s (B, 1, Hq, D)."""
    top = m.amax(dim=0, keepdim=True)
    alpha = torch.exp(m - top)
    out = (acc * alpha).sum(dim=0) / (l * alpha).sum(dim=0)
    bsz, hkv, g, d = out.shape
    return out.reshape(bsz, 1, hkv * g, d).to(dtype)
