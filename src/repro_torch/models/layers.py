"""Shared neural-net primitives: RMSNorm, SwiGLU, RoPE and M-RoPE, the
cross-entropy loss, and the parameter container of the model zoo.

The counterparts of the JAX package's ``models/layers.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (active_rules, constrain,
                                              is_dtensor, local_apply,
                                              local_shape_offset)

__all__ = ["rmsnorm", "swiglu", "rope_cos_sin", "m_rope_cos_sin",
           "apply_rope", "softmax_cross_entropy", "ParamGroup",
           "normal_init"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMS-normalise the last axis in fp32 and scale by ``1 + w`` (the
    weights are stored as offsets from one, so zeros are the identity)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def _unpinned(x, *spec):
    return x


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, pin=_unpinned) -> torch.Tensor:
    """``pin(t, *spec)`` lays out the (B, S, F) hidden halves over
    ``model`` and the output over the batch (a sharding constraint)."""
    g = pin(F.silu(x @ wg), None, None, "model")
    u = pin(x @ wu, None, None, "model")
    return pin((g * u) @ wd, "data", None, None)


def _rope_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """theta ** (-i / half) for i < half, in fp32."""
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) → cos/sin (..., S, head_dim//2) in fp32."""
    ang = positions[..., None].float() * _rope_freq(head_dim, theta,
                                                     positions.device)
    return torch.cos(ang), torch.sin(ang)


def m_rope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                   sections: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: positions3 (3, ..., S); the half-dim frequency
    bands are split into (t, h, w) sections, each rotated by its own
    position stream. Returns cos/sin shaped (..., S, head_dim//2)."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    ang_per = positions3[..., None].float() * _rope_freq(
        head_dim, theta, positions3.device)            # (3, ..., S, half)
    # band j takes stream i for the j of section i (the reference's
    # take_along_axis over the stream axis)
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    ang = torch.cat([ang_per[i, ..., bounds[i]: bounds[i + 1]]
                     for i in range(3)], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D//2) — rotate-half convention."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions, in fp32; logits (..., V),
    labels (...). An ignored label gathers class 0 (the reference's
    ``maximum(labels, 0)``) and is masked out of the mean."""
    if is_dtensor(logits) and active_rules() is not None:
        tok = _vocab_parallel_cross_entropy(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(labels.long(), min=0)
                            .unsqueeze(-1)).squeeze(-1)
        tok = lse - gold
    mask = (labels != ignore_index).float()
    return torch.sum(tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _vocab_parallel_cross_entropy(logits, labels):
    """Each position's cross-entropy with the vocab left sharded over
    ``model`` (the reference's per-shard logits and global softmax): the
    max, the exponential sum and the gold logit are per-shard partials,
    combined by small per-position collectives."""
    r = active_rules()
    logits = constrain(logits.float(), "data", None, r.model_axis)
    top = constrain(logits.detach().amax(dim=-1), "data", None)
    lse = top + torch.log(constrain(
        torch.exp(logits - top[..., None]).sum(dim=-1), "data", None))
    start = local_shape_offset(logits.shape, logits.device_mesh,
                               logits.placements)[1][-1]

    def shard_gold(logits, labels):
        ids = torch.clamp(labels.long(), min=0) - start
        hit = (ids >= 0) & (ids < logits.shape[-1])
        gold = torch.gather(logits, -1, torch.where(hit, ids, 0)
                            .unsqueeze(-1)).squeeze(-1)
        return torch.where(hit, gold, 0.0)

    gold = local_apply(shard_gold, (logits, labels),
                       (("data", None, r.model_axis), ("data", None)),
                       (("data", None), labels.shape, (r.model_axis,)))
    return lse - constrain(gold, "data", None)


class ParamGroup(nn.Module):
    """One block's weights — a node of the JAX package's parameter tree —
    as parameters (tensors) and child groups (modules). Members are read
    by name, ``p["wz"]``, as the reference reads its dicts. Parameters are
    made frozen, as serving wants them; the train step turns gradients on
    (``params.requires_grad_(True)``)."""

    def __init__(self, **members):
        super().__init__()
        for name, value in members.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def normal_init(shape, scale: float, generator: torch.Generator, *,
                device, dtype=torch.float32) -> torch.Tensor:
    """``scale · N(0, 1)`` of ``shape``, drawn in fp32 from ``generator``
    on ``device`` and cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)
