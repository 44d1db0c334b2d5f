"""Int8 KV-cache quantization.

The counterpart of the JAX package's ``serve/quant.py``: symmetric
per-(layer, position, head) scales over the head_dim axis — position-wise
scales keep early-token outliers from poisoning late-token precision, and
the scale tensor is seq × heads (small beside the cache itself). Values
round half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import torch

__all__ = ["quantize_kv", "dequantize_kv", "quantized_cache_bytes"]


def _q(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # x (..., head_dim): scale over the head_dim axis
    scale = x.float().abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(cache: dict) -> dict:
    """Returns a new cache dict with k/v as (int8 values, fp32 scales)."""
    out = dict(cache)
    for key in ("k", "v"):
        if key in cache:
            q, s = _q(cache[key])
            out[key + "_q"] = q
            out[key + "_scale"] = s
            del out[key]
    return out


def dequantize_kv(cache: dict, dtype=torch.bfloat16) -> dict:
    out = dict(cache)
    for key in ("k", "v"):
        qk, sk = key + "_q", key + "_scale"
        if qk in cache:
            out[key] = (cache[qk].float() * cache[sk]).to(dtype)
            del out[qk], out[sk]
    return out


def quantized_cache_bytes(cache: dict) -> tuple[int, int]:
    """(bf16 bytes, int8 + scales bytes) for the attention cache portion."""
    full = 0
    quant = 0
    for key in ("k", "v"):
        if key in cache:
            n = cache[key].numel()
            full += n * 2
            quant += n * 1 + (n // cache[key].shape[-1]) * 4
    return full, quant
