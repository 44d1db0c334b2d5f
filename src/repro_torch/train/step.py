"""Training step: grad-accumulation microbatching, remat, AdamW, optional
error-feedback gradient compression, non-finite step skip.

The counterpart of the JAX package's ``train/step.py``. ``make_train_step``
returns ``train_step(params, opt_state, batch[, residuals])`` →
``(params, opt_state[, residuals], metrics)``. The global batch is split
into ``microbatches`` along its leading axis and their gradients summed
in fp32, then divided by their count: activation memory scales with the
microbatch. Parameters and moments are updated in place (see
:func:`~repro_torch.optim.adamw.adamw_update`); whether the step is taken
is decided before they are touched, so no second copy of the model is
needed.

With DTensor parameters (see :mod:`repro_torch.distributed.sharding`), run
the step under the sharding rules and ``implicit_replication()``: a
sharded batch is gathered before it is split into microbatches (the
model's first constraint re-shards each one), and each gradient is laid
out as its parameter before the update.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed.compression import ef_compress_grads
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     global_norm, named_tensors,
                                     warmup_cosine)

__all__ = ["TrainConfig", "make_train_step", "microbatch_grads"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: bool = True
    use_pallas: bool = False
    compress_grads: bool = False
    skip_nonfinite: bool = True
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def _split_micro(batch: dict, n: int) -> dict:
    """Each leaf as (n, ...): the leading axis split into n microbatches,
    or the leaf broadcast to all n where that axis does not divide."""
    def sp(x):
        if x.ndim >= 2 and x.shape[0] % n == 0 and x.shape[0] >= n:
            return x.reshape(n, x.shape[0] // n, *x.shape[1:])
        return x[None].expand(n, *x.shape)
    out = {}
    for k, v in batch.items():
        if is_dtensor(v):
            from torch.distributed.tensor import Replicate
            mesh = v.device_mesh
            v = v.redistribute(mesh, [Replicate()] * mesh.ndim)
        if k == "positions3":   # (3, B, S) — batch is axis 1
            v = v.movedim(1, 0)
            v = v.reshape(n, v.shape[0] // n, *v.shape[1:])
            out[k] = v.movedim(2, 1)
        else:
            out[k] = sp(v)
    return out


def microbatch_grads(cfg, tcfg: TrainConfig, params, batch: dict):
    """(``{name: gradient}``, mean loss) of ``batch`` over
    ``tcfg.microbatches``: one backward pass each, the gradients summed in
    fp32 — an fp32 parameter's ``.grad`` is that sum, accumulated in
    place — then divided by their count (with one microbatch, each
    gradient in its parameter's dtype, as the reference's)."""
    n = tcfg.microbatches
    named = named_tensors(params)
    micros = [batch]
    if n > 1:
        split = _split_micro(batch, n)
        micros = [{k: v[i] for k, v in split.items()} for i in range(n)]
    for _, p in named:
        p.grad = None
    wide: dict = {}           # fp32 sums for parameters of other dtypes
    lsum = 0.0
    for mb in micros:
        loss = loss_fn(cfg, params, mb, remat=tcfg.remat,
                       use_pallas=tcfg.use_pallas)
        loss.backward()
        lsum = lsum + loss.detach()
        for name, p in named:
            if n > 1 and p.dtype != torch.float32 and p.grad is not None:
                wide[name] = (p.grad.float() if name not in wide
                              else wide[name].add_(p.grad))
                p.grad = None
    grads = {}
    for name, p in named:
        g = wide.get(name, p.grad)
        if g is None:         # a parameter the loss does not reach
            g = torch.zeros_like(p, dtype=torch.float32 if n > 1
                                 else p.dtype)
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        grads[name] = g.div_(n) if n > 1 else g
        p.grad = None
    return grads, lsum / n


def make_train_step(cfg, tcfg: TrainConfig):
    """cfg: ModelConfig. Returns f(params, opt_state, batch[, residuals])."""

    def train_step(params, opt_state: OptState, batch: dict,
                   residuals: Optional[dict] = None):
        if tcfg.compress_grads and residuals is None:
            raise ValueError("compression needs residual state")
        params.requires_grad_(True)
        grads, loss = microbatch_grads(cfg, tcfg, params, batch)
        if tcfg.compress_grads:
            grads, residuals = ef_compress_grads(grads, residuals)
        norm = global_norm(grads.values())
        ok = True
        if tcfg.skip_nonfinite:
            # decided before the parameters are touched
            ok = bool(torch.isfinite(loss) & torch.isfinite(norm))
        if ok:
            params, opt_state, metrics = adamw_update(
                params, grads, opt_state, tcfg.optimizer, grad_norm=norm)
        else:
            metrics = {"lr": warmup_cosine(tcfg.optimizer,
                                           opt_state.step + 1),
                       "grad_norm": norm}
        if tcfg.skip_nonfinite:
            metrics["skipped"] = int(not ok)
        metrics["loss"] = loss
        if tcfg.compress_grads:
            return params, opt_state, residuals, metrics
        return params, opt_state, metrics

    return train_step
