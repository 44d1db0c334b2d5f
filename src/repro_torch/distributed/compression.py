"""Error-feedback int8 gradient compression.

The counterpart of the JAX package's ``distributed/compression.py``: each
gradient tensor is quantized to int8 with one scale per tensor,
``max|x| / 127``, and the quantization residual is fed back into the next
step's gradient, so ``compress(g) + residual`` carries all of the
gradient's mass. ``torch.round`` rounds half to even, as ``jnp.round``
does, so the int8 codes equal the reference's on equal inputs.
Gradients and residuals are dicts keyed by parameter name.
"""
from __future__ import annotations

import torch

__all__ = ["init_residuals", "compress_decompress", "ef_compress_grads"]


def init_residuals(params) -> dict:
    """Zero fp32 residuals of the shapes (and on the device) of a dict of
    tensors or a module's ``named_parameters()``."""
    items = (params.items() if isinstance(params, dict)
             else params.named_parameters())
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in items}


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(x: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Returns (dequantized int8 round trip, residual), both fp32."""
    x32 = x.float()
    q, scale = _quantize(x32)
    deq = q.float() * scale
    return deq, x32 - deq


def ef_compress_grads(grads: dict, residuals: dict) -> tuple[dict, dict]:
    """Error-feedback compression of ``{name: gradient}``: returns (the
    compressed gradients in their dtypes, the new residuals)."""
    out, res = {}, {}
    for name, g in grads.items():
        deq, res[name] = compress_decompress(g.float() + residuals[name])
        out[name] = deq.to(g.dtype)
    return out, res
