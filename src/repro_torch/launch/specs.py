"""Dry-run step builders: abstract inputs (fake tensors — no allocation)
laid out on a mesh by the sharding rules, for every (arch × shape) cell.

The counterpart of the JAX package's ``launch/specs.py``.
``build_cell(arch, shape_name, mesh)`` returns a :class:`Cell` with

* ``fn``   — the step (train step / prefill pass / decode step), run under
  the cell's rules and ``implicit_replication()``;
* ``args`` — fake DTensor stand-ins: parameters by ``param_specs``, the
  optimizer moments ZeRO-1 (``param_specs(fsdp=True)``), the batch by
  ``batch_specs``, the serving cache by ``cache_specs``;

which :mod:`repro_torch.launch.dryrun` traces. Where the reference hands
jit in/out shardings, the port's arguments carry their layouts.
``periods`` cuts the model to that many layer periods (a period is one
layer, or the hybrid family's group of Mamba2 layers and its shared block)
for the dry-run's extrapolation; the sharding policy stays the full
model's.

Two differences from the reference's cells, both for tracing on fake
tensors, which hold no values: the train step runs with
``skip_nonfinite=False`` (the skip decision reads the loss on the host),
and its step counter is a real 0-d tensor (the schedule's scalars are
host floats); the prefill cell is the forward pass that collects the
serving state, without its copy into a preallocated cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_applicable
from repro_torch.data.pipeline import DataConfig, batch_spec
from repro_torch.distributed import sharding as shd
from repro_torch.launch.flop_cost import abstract, fake_mode
from repro_torch.launch.presets import preset_for
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig, OptState, init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["Cell", "build_cell", "input_specs", "abstract_params",
           "make_rules", "period_layers", "num_periods"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: Callable
    args: tuple
    cfg: ModelConfig
    dtype: Any           # the weights' dtype: picks the roofline's peak
    notes: str = ""


def make_rules(mesh, cfg=None) -> shd.Rules:
    axes = mesh.mesh_dim_names
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    fsdp = False
    if cfg is not None:
        fsdp = shd.fsdp_policy(cfg, shd.mesh_shape(mesh)["model"])
    return shd.Rules(mesh=mesh, data_axes=data_axes, model_axis="model",
                     fsdp=fsdp)


def period_layers(cfg: ModelConfig) -> int:
    """Layers in one period of the model."""
    return cfg.hybrid_attn_every if cfg.family == "hybrid" else 1


def num_periods(cfg: ModelConfig) -> int:
    return cfg.num_layers // period_layers(cfg)


def _data_cfg(cfg: ModelConfig, shape: ShapeSpec) -> DataConfig:
    return DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, frontend=cfg.frontend,
        d_model=cfg.d_model, m_rope=cfg.m_rope)


def input_specs(arch: str, shape_name: str, *, mode=None,
                float_dtype=None, cfg=None, shape=None) -> dict:
    """Fake stand-ins for the model inputs of one cell (embeddings in the
    arch's preset parameter dtype unless ``float_dtype`` says; ``cfg`` and
    ``shape`` stand in for the arch's config and the named shape)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    fdt = float_dtype or preset_for(arch).param_dtype
    if shape.kind in ("train", "prefill"):
        spec = batch_spec(_data_cfg(cfg, shape), mode=mode, float_dtype=fdt)
        if shape.kind == "prefill":
            spec.pop("labels")
        return spec
    # decode: one new token against a seq_len cache
    b = shape.global_batch
    if cfg.frontend == "tokens":
        spec = {"tokens": abstract((b, 1), torch.int32, mode=mode)}
    else:
        spec = {"embeddings": abstract((b, 1, cfg.d_model), fdt,
                                       mode=mode)}
        if cfg.m_rope:
            spec["positions3"] = abstract((3, b, 1), torch.int32, mode=mode)
    return spec


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16, *, mode=None):
    """``init_params`` of ``cfg`` on fake tensors: no allocation."""
    with mode or fake_mode():
        return tfm.init_params(cfg, 0, device="cpu", dtype=dtype)


def _abstract_cache(cfg: ModelConfig, shape: ShapeSpec,
                    dtype=torch.bfloat16, *, mode=None) -> dict:
    with mode or fake_mode():
        return tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                              dtype=dtype, device="cpu")


def build_cell(arch: str, shape_name: str, mesh, *,
               microbatches: int | None = None,
               periods: int | None = None, cfg: ModelConfig | None = None,
               shape: ShapeSpec | None = None) -> Cell:
    """``cfg`` and ``shape`` stand in for the arch's config and the named
    shape (a smoke-sized cell); with ``mesh=None`` the cell is the
    unsharded program on plain fake tensors."""
    full = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(full, shape)
    if not ok:
        raise ValueError(f"{arch}×{shape_name} skipped: {why}")
    cfg = full
    if periods is not None:
        cfg = dataclasses.replace(full,
                                  num_layers=periods * period_layers(full))
    preset = preset_for(arch)
    rules = make_rules(mesh, full) if mesh is not None else None
    mode = fake_mode()
    params = abstract_params(cfg, preset.param_dtype, mode=mode)
    batch = input_specs(arch, shape_name, mode=mode, cfg=cfg, shape=shape)
    if rules is not None:
        with mode:
            shd.shard_params(params, mesh, shd.param_specs(cfg, rules))
            bspecs = shd.batch_specs(cfg, rules, shape.kind)
            batch = {k: shd.shard_tensor(v, mesh, bspecs.get(k, ()))
                     for k, v in batch.items()}

    def under_rules(step):
        def fn(*args):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with shd.use_rules(rules), implicit_replication():
                return step(*args)
        return fn

    if shape.kind == "train":
        ocfg = AdamWConfig(moment_dtype=preset.moment_dtype)
        tcfg = TrainConfig(
            microbatches=(microbatches if microbatches is not None
                          else preset.microbatches),
            skip_nonfinite=False, optimizer=ocfg)
        with mode:
            opt = init_opt_state(params, ocfg, device="cpu")
            if rules is not None:
                opt = shd.shard_opt_state(opt, mesh, shd.param_specs(
                    cfg, rules, fsdp=True))
        # a real step counter: the schedule's scalars are host floats
        opt = OptState(torch.zeros((), dtype=torch.int32), opt.mu, opt.nu)
        return Cell(arch, shape, under_rules(make_train_step(cfg, tcfg)),
                    (params, opt, batch), cfg, preset.param_dtype,
                    notes=f"microbatches={tcfg.microbatches}")

    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                return tfm.forward(cfg, params, batch, collect_kv=True)

        return Cell(arch, shape, under_rules(prefill), (params, batch), cfg,
                    preset.param_dtype,
                    notes="prefill: forward collecting the serving state")

    # decode
    seq_parallel = shape.name == "long_500k"
    cache = _abstract_cache(cfg, shape, preset.param_dtype, mode=mode)
    if rules is not None:
        with mode:
            cache = shd.shard_cache(cache, mesh, shd.cache_specs(
                cfg, rules, seq_parallel=seq_parallel))

    def decode(params, batch, cache):
        return tfm.decode_step(cfg, params, batch, cache)

    return Cell(arch, shape, under_rules(decode), (params, batch, cache),
                cfg, preset.param_dtype,
                notes=("seq-parallel cache" if seq_parallel else ""))
