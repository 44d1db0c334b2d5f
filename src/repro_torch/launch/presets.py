"""Per-architecture launch presets: microbatching, dtypes, and notes.

The counterpart of the JAX package's ``launch/presets.py``, with torch
dtypes. Its microbatch counts were sized for the reference's production
mesh (the per-device rematerialization residual near or under ~1 GB);
the port's training driver takes ``microbatches`` from its caller, and
``chip_smoke.py`` follows zamba2-2.7b's preset (2).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["LaunchPreset", "PRESETS", "preset_for"]


@dataclasses.dataclass(frozen=True)
class LaunchPreset:
    microbatches: int = 1
    param_dtype: object = torch.bfloat16
    moment_dtype: object = torch.float32
    note: str = ""


PRESETS: dict[str, LaunchPreset] = {
    "llama3-405b": LaunchPreset(
        microbatches=16, moment_dtype=torch.bfloat16,
        note="405B: bf16 moments + 16 microbatches (8 was tried: collective "
             "-7% but activation temp 2x — refuted, see §Perf iter 5)"),
    "qwen2-vl-72b": LaunchPreset(microbatches=8),
    "granite-34b": LaunchPreset(microbatches=4),
    "command-r-35b": LaunchPreset(microbatches=4),
    "qwen3-14b": LaunchPreset(microbatches=2),
    "zamba2-2.7b": LaunchPreset(microbatches=2),
    "moonshot-v1-16b-a3b": LaunchPreset(microbatches=2),
    "musicgen-large": LaunchPreset(microbatches=1),
    "mamba2-370m": LaunchPreset(microbatches=1),
    "granite-moe-3b-a800m": LaunchPreset(microbatches=1),
}


def preset_for(arch: str) -> LaunchPreset:
    return PRESETS.get(arch, LaunchPreset())
