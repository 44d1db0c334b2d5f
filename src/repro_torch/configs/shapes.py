"""Assigned input shapes (LM family): seq_len × global_batch per shape id.

``train_*`` lowers ``train_step``; ``prefill_*`` lowers the prefill forward;
``decode_*``/``long_*`` lower ``serve_step`` (one new token against a KV/SSM
cache of ``seq_len``). ``long_500k`` requires a sub-quadratic backbone and is
skipped for pure full-attention archs (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(applicable?, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token decode is "
                       "quadratic-cost; skipped per assignment "
                       "(DESIGN.md §Arch-applicability)")
    return True, ""
