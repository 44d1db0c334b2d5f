"""Collective accounting: the counterpart of the JAX package's
``launch/hlo_graph.py::collective_stats``.

The reference reads the collectives that XLA's SPMD partitioner put in the
optimized HLO, and multiplies the ones inside while-loop bodies by an
inferred trip count. The port has neither HLO nor loops to infer: its
programs run eagerly (every loop is unrolled, or its cost extrapolated by
the dry-run from whole periods), and DTensor issues each collective as a
functional-collective op (``_c10d_functional.*``) while the traced
function runs. :class:`CollectiveLog` records them, each with its per-rank
result bytes; :func:`collective_stats` sums them into the reference's
output shape. All-reduce is counted twice on the wire (the ring's
reduce-scatter + all-gather), as the reference's ``_WIRE_FACTOR``.
Collectives keep their dtype here, so there is no ``wire_bytes_tpu``
correction.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveLog", "collective_op", "collective_stats",
           "scale_stats", "OPS"]

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}

# op-name prefixes of the functional collectives (and the autograd-aware
# variants DTensor's backward issues)
_PREFIXES = (("all_reduce", "all-reduce"),
             ("all_gather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"),
             ("all_to_all", "all-to-all"),
             ("permute_tensor", "collective-permute"),
             ("broadcast", "broadcast"))
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def collective_op(func) -> str | None:
    """The collective an aten-level op is (reference naming), or None."""
    ns = getattr(func, "namespace", None)
    if ns not in _NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    for prefix, op in _PREFIXES:
        if name.startswith(prefix):
            return op
    return None


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return int(math.prod(out.shape)) * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class CollectiveLog(TorchDispatchMode):
    """Records ``(op, per-rank bytes)`` for every functional collective
    dispatched while active (``records``)."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = collective_op(func)
        if op is not None:
            self.records.append((op, _nbytes(out)))
        return out


def collective_stats(records) -> dict:
    """{op: {count, bytes, wire_bytes}} over ``(op, bytes)`` records,
    plus ``_total``."""
    out: dict = {}
    for op, nbytes in records:
        ent = out.setdefault(op, {"count": 0.0, "bytes": 0.0,
                                  "wire_bytes": 0.0})
        ent["count"] += 1
        ent["bytes"] += nbytes
        ent["wire_bytes"] += nbytes * _WIRE_FACTOR[op]
    keys = ("count", "bytes", "wire_bytes")
    out["_total"] = {k: sum(v[k] for kk, v in out.items()
                            if kk != "_total") for k in keys}
    return out


def scale_stats(one: dict, two: dict, periods: int) -> dict:
    """Stats of a program of ``periods`` identical periods from those of
    its cuts to one and two periods: one + (periods − 1) × (two − one),
    entry by entry."""
    out: dict = {}
    for op in set(one) | set(two):
        a = one.get(op, {})
        b = two.get(op, {})
        out[op] = {k: a.get(k, 0.0) + (periods - 1) * (b.get(k, 0.0)
                                                       - a.get(k, 0.0))
                   for k in set(a) | set(b)}
    return out
