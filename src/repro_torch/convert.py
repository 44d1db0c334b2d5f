"""Carry state across from the JAX package's objects to the port's.

The two packages never import each other; what crosses is plain numpy.
A caller that holds one of the JAX package's device formats turns it into
``{field name: numpy value}`` (``np.asarray`` of every dataclass field)
and hands the dict to :func:`packed_from_numpy`; a plan goes through
:func:`plan_from_numpy` the same way. Both packages then compute on the
same packed operands.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BCC, CSR, CSRCluster, CompactedC, TiledCSR
from repro_torch.planner.plan_cache import Plan

__all__ = ["PACKED_KINDS", "tensor_from_numpy", "packed_from_numpy",
           "plan_from_numpy"]

PACKED_KINDS = {cls.__name__: cls
                for cls in (CSR, CSRCluster, BCC, TiledCSR, CompactedC)}


def tensor_from_numpy(x, *, device) -> torch.Tensor:
    """One numpy array → a tensor on ``device`` (bfloat16 arrays, which
    numpy only knows through an extension dtype, keep their bits)."""
    x = np.array(x, copy=True, order="C")     # a writable copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def packed_from_numpy(kind: str, fields: dict, *, device):
    """Build the port's ``kind`` format (``"CSR"``, ``"CSRCluster"``,
    ``"BCC"``, ``"TiledCSR"`` or ``"CompactedC"``) from a dict of its
    fields: arrays become tensors on ``device``, the static fields
    (``nrows``, ``block_k`` …; 0-d arrays accepted) become ints."""
    cls = PACKED_KINDS[kind]
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = fields[f.name]
        if f.name in cls._static:
            kwargs[f.name] = int(np.asarray(value))
        else:
            kwargs[f.name] = tensor_from_numpy(value, device=device)
    return cls(**kwargs)


def plan_from_numpy(fields: dict) -> Plan:
    """Build a port :class:`Plan` from a dict of a plan's fields (0-d
    arrays are unwrapped to Python values; ``perm``/``boundaries`` stay
    int64 arrays or ``None``)."""
    kwargs = {}
    for f in dataclasses.fields(Plan):
        if f.name not in fields:
            continue
        value = np.asarray(fields[f.name])
        if f.name in ("perm", "boundaries"):
            value = None if value.dtype == object else value.astype(np.int64)
        elif value.ndim == 0:
            value = value.item()
        kwargs[f.name] = value
    return Plan(**kwargs)
