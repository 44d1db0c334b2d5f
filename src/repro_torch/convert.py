"""Carry state across from the JAX package's objects to the port's.

The two packages never import each other; what crosses is plain numpy.
A caller that holds one of the JAX package's device formats turns it into
``{field name: numpy value}`` (``np.asarray`` of every dataclass field)
and hands the dict to :func:`packed_from_numpy`; a plan goes through
:func:`plan_from_numpy` the same way. Both packages then compute on the
same packed operands. An LM's parameters cross the same way:
:func:`lm_params_from_numpy` takes the reference's parameter tree with
numpy leaves — and so do its gradients, which share that tree, and its
optimizer moments: loaded the same way, each lands under the name of its
parameter in the port's ``named_parameters()``, ready to compare.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BCC, CSR, CSRCluster, CompactedC, TiledCSR
from repro_torch.planner.plan_cache import Plan

__all__ = ["PACKED_KINDS", "tensor_from_numpy", "packed_from_numpy",
           "plan_from_numpy", "lm_params_from_numpy"]

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
    build, names = cls, [f.name for f in dataclasses.fields(cls)]
    if cls is CompactedC:
        # the JAX package's CompactedC holds its dense window table, from
        # which the port's takes its live window keys
        build, names = CompactedC.from_table, ["slabs", "table",
                                               *cls._static]
    kwargs = {}
    for name in names:
        value = fields[name]
        if name in cls._static:
            kwargs[name] = int(np.asarray(value))
        else:
            kwargs[name] = tensor_from_numpy(value, device=device)
    return build(**kwargs)


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


def lm_params_from_numpy(cfg, tree: dict, *, device):
    """Load an LM parameter tree laid out as the JAX package's
    ``init_params`` makes it — ``{"embed", "layers": {...}, "shared_attn":
    {"attn": {…}, "mlp": {…}}, "final_norm", "lm_head"}`` with numpy
    leaves, the layers' leaves stacked on a leading layer axis
    (``{"ssm": {…}}``, ``{"attn": {…}, "mlp": {…}}`` or ``{"attn": {…},
    "moe": {…}}``); no ``embed`` for the ``embeddings`` frontend, no
    ``lm_head`` with tied embeddings — into the port's modules
    (:func:`repro_torch.models.transformer.init_params`'s layout) on
    ``device``."""
    from torch import nn

    from repro_torch.device import resolve_device
    from repro_torch.models.layers import ParamGroup
    from repro_torch.models.mamba2 import MAMBA2_PARAM_NAMES
    from repro_torch.models.transformer import check_family

    check_family(cfg)
    dev = resolve_device(device)

    def group(leaves: dict, index=None) -> ParamGroup:
        return ParamGroup(**{
            name: tensor_from_numpy(value if index is None
                                    else np.asarray(value)[index],
                                    device=dev)
            for name, value in leaves.items()})

    stacked = tree["layers"]
    if cfg.family in ("ssm", "hybrid"):
        missing = set(MAMBA2_PARAM_NAMES) - set(stacked["ssm"])
        if missing:
            raise KeyError(f"Mamba2 leaves missing: {sorted(missing)}")
        layers = (group(stacked["ssm"], i) for i in range(cfg.num_layers))
    else:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        layers = (ParamGroup(attn=group(stacked["attn"], i),
                             **{ffn: group(stacked[ffn], i)})
                  for i in range(cfg.num_layers))
    members = {}
    if cfg.frontend == "tokens":
        members["embed"] = tensor_from_numpy(tree["embed"], device=dev)
    members["layers"] = nn.ModuleList(layers)
    if cfg.family == "hybrid":
        members["shared_attn"] = ParamGroup(
            attn=group(tree["shared_attn"]["attn"]),
            mlp=group(tree["shared_attn"]["mlp"]))
    members["final_norm"] = tensor_from_numpy(tree["final_norm"], device=dev)
    if not cfg.tie_embeddings:
        members["lm_head"] = tensor_from_numpy(tree["lm_head"], device=dev)
    return ParamGroup(**members)
