"""Device resolution for the port's entry points.

Everything device-side in the port takes an explicit ``device``. The
serving entry points default to ``"cuda"``; this module turns that choice
into a :class:`torch.device` and refuses to carry on silently when the
card is missing — a CUDA request without a card raises, it never falls
back to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a :class:`torch.device`) →
    :class:`torch.device`; raises :class:`RuntimeError` for a CUDA device
    when no card is visible, :class:`ValueError` for any other type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain torch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
