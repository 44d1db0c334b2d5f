"""AdamW with dtype-configurable moments, global-norm clipping and a
warmup-cosine schedule.

The counterpart of the JAX package's ``optim/adamw.py``, on the port's
parameter tree: a :class:`~repro_torch.models.layers.ParamGroup` (its
``named_parameters()`` order) or a dict of tensors. The moments are dicts
keyed by the same names, and ``adamw_update`` writes the new parameters
and moments into their tensors in place (one full-size copy of the model
is 9.7 GB for zamba2-2.7b). The reference's order of operations is kept:
clip by the global norm, then bias-correct; weight decay applies to every
tensor, norms included; moments are stored in ``moment_dtype`` and
computed in fp32, as are the schedule's scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "warmup_cosine", "global_norm", "clip_by_global_norm",
           "named_tensors"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor     # 0-d int32: updates taken so far
    mu: dict               # first moment, {parameter name: tensor}
    nu: dict               # second moment


def named_tensors(tree) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) pairs of a parameter tree: a module's
    ``named_parameters()``, or a dict's items in its order."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    return list(tree.items())


def init_opt_state(params, cfg: AdamWConfig, *, device="cuda") -> OptState:
    """Zero moments of the parameters' shapes in ``cfg.moment_dtype`` on
    ``device`` (the card unless the caller asks for the CPU), step 0."""
    dev = resolve_device(device)
    zeros = {name: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=dev)
             for name, p in named_tensors(params)}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros,
                    nu={k: torch.zeros_like(v) for k, v in zeros.items()})


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (int or tensor), as a 0-d fp32 tensor
    on the CPU: linear warmup to ``lr_peak``, then a cosine down to
    ``lr_min_ratio × lr_peak`` at ``total_steps``."""
    step = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, each tensor summed in
    fp32 (a 0-d fp32 tensor on the tensors' device)."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tensors])))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tensors, max_norm: float):
    """(each tensor scaled by min(1, max_norm / global norm), in fp32 and
    cast back to its dtype; the norm before the clip)."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    scale = _clip_scale(norm, max_norm)
    return [(g.float() * scale).to(g.dtype) for g in tensors], norm


def adamw_update(params, grads: dict, state: OptState, cfg: AdamWConfig, *,
                 grad_norm: torch.Tensor | None = None):
    """One AdamW step: ``grads`` maps each parameter's name to its
    gradient. Writes the new parameters and moments in place and returns
    ``(params, new state, {"lr", "grad_norm"})`` — the grad norm taken
    before the clip (``grad_norm``, when the caller has computed it from
    the same gradients already)."""
    named = named_tensors(params)
    gs = [grads[name] for name, _ in named]
    norm = global_norm(gs) if grad_norm is None else grad_norm
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    step_f = step.to(device="cpu", dtype=torch.float32)
    # the schedule's scalars in fp32, as the reference computes them
    bc1 = float(1 - cfg.b1 ** step_f)
    bc2 = float(1 - cfg.b2 ** step_f)
    lr_f = float(lr)
    b1, b2 = cfg.b1, cfg.b2
    with torch.no_grad():
        for (name, p), g in zip(named, gs):
            m, v = state.mu[name], state.nu[name]
            # clip_by_global_norm's arithmetic, one tensor at a time (no
            # clipped copy of every gradient)
            g32 = (g.float() * scale).to(g.dtype).float()
            m32 = m.float() * b1 + g32 * (1 - b1)
            v32 = v.float() * b2 + g32 * g32 * (1 - b2)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr_f * delta)
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": norm}
