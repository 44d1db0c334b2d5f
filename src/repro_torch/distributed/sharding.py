"""Logical-axis sharding rules: parameter specs and activation constraints
for the production mesh, over a :class:`torch.distributed.device_mesh.DeviceMesh`.

The counterpart of the JAX package's ``distributed/sharding.py``, with the
same policy:

* **Size-aware FSDP**: weights shard over *both* the ``data`` (ZeRO-3) and
  ``model`` (TP/EP) axes only when the TP-only footprint exceeds ~10 GB per
  device (llama3-405B); smaller models replicate weights across data.
  Optimizer moments always shard over (data, model) (ZeRO-1).
* **TP**: projection output dims shard over ``model`` when divisible; KV
  projections shard over ``model`` only when ``num_kv_heads`` divides the
  model-axis size (MQA replicates KV — granite-34b).
* **EP-vs-TP MoE policy**: experts shard over ``model`` when the padded
  expert count divides the model axis, else the per-expert ``d_ff`` does.
* **Vocab parallelism**: embedding table V over ``model``; LM head output
  vocab over ``model``.
* **Batch**: global batch shards over ``(pod, data)``; the pod axis is pure
  DP.

A spec is a plain tuple with one entry per tensor dimension: ``None``, a
mesh-axis name, or a tuple of names — the ``PartitionSpec`` vocabulary, so
a spec compares entry for entry with the reference's. The port keeps one
:class:`~repro_torch.models.layers.ParamGroup` per layer, so its layer
specs have no leading layer-stack entry; the serving cache keeps its
leading layer axis, and so do its specs. :func:`placements` turns a spec
into DTensor placements; :func:`shard_params` places a parameter tree.

Activation constraints go through :func:`constrain`, a no-op unless a
``Rules`` context is active and the tensor is a DTensor — model code stays
mesh-agnostic, and on plain tensors every output is unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Optional

import torch

__all__ = ["Rules", "active_rules", "use_rules", "constrain",
           "constrain_if_fsdp", "fsdp_active", "param_specs", "batch_specs",
           "cache_specs", "moe_policy", "fsdp_policy", "placements",
           "spec_from_placements", "named_specs", "shard_params",
           "shard_tensor", "shard_opt_state", "shard_cache", "is_dtensor",
           "local_apply", "pin_grad", "sanitize", "local_shape_offset",
           "FSDP_THRESHOLD_BYTES"]

# a plain tensor's attribute: the ranks that split the work of the
# local_apply region it belongs to
COST_SHARE = "_cost_share"

_RULES: contextvars.ContextVar[Optional["Rules"]] = \
    contextvars.ContextVar("sharding_rules", default=None)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Any                        # torch.distributed DeviceMesh
    data_axes: tuple = ("data",)     # ("pod","data") multi-pod
    model_axis: str = "model"
    fsdp: bool = False               # weights ZeRO-3-sharded over data?

    @property
    def model_size(self) -> int:
        return mesh_shape(self.mesh)[self.model_axis]

    @property
    def data_size(self) -> int:
        shape = mesh_shape(self.mesh)
        n = 1
        for a in self.data_axes:
            n *= shape[a]
        return n

    # logical axis → mesh axes
    @property
    def batch(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def over_model(self, n: int):
        """The model axis where it evenly divides ``n`` (a head or group
        count, a feature width), else None: the one layout test of the
        parameter and cache specs and of the model's per-rank regions."""
        return self.model_axis if n and n % self.model_size == 0 else None


def active_rules() -> Optional[Rules]:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(tok)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= shape[a]
        return n
    return shape[entry]


def fsdp_active() -> bool:
    r = _RULES.get()
    return bool(r and r.fsdp)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain_if_fsdp(x, *spec):
    """Constraint applied only under ZeRO-3 weight sharding (the
    reference's pins that fix FSDP propagation; TP-only layouts skip
    them)."""
    return constrain(x, *spec) if fsdp_active() else x


def sanitize(mesh, spec: tuple, shape) -> tuple:
    """``spec`` padded to ``len(shape)`` entries, with every entry that does
    not evenly divide its dimension dropped (batch = 1 long-context decode
    cannot shard batch over data, etc.)."""
    entries = tuple(spec[: len(shape)]) + (None,) * max(
        0, len(shape) - len(spec))
    clean = []
    for dim, entry in zip(shape, entries):
        n = _axis_size(mesh, entry)
        clean.append(entry if (n > 1 and dim % n == 0) else None)
    return tuple(clean)


def _resolve(r: Rules, spec) -> tuple:
    """The logical ``"data"`` entry as the configured data axes."""
    return tuple(r.batch if e == "data" else e for e in spec)


def constrain(x, *spec):
    """Redistribute a DTensor ``x`` to ``spec`` iff a Rules context is
    active (the reference's ``with_sharding_constraint``); a plain tensor,
    or any tensor without rules, is returned as it is.

    The logical ``"data"`` resolves to the configured data axes, and entries
    that do not evenly divide their dimension are dropped — model code
    states *intent*, the rules decide feasibility."""
    r = _RULES.get()
    if r is None or not is_dtensor(x):
        return x
    want = placements(r.mesh, sanitize(r.mesh, _resolve(r, spec), x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(r.mesh, want)


class _PinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def pin_grad(x, *spec):
    """``x`` itself, whose gradient is redistributed to ``spec`` in the
    backward pass (a DTensor under active rules; otherwise ``x``). It keeps
    a layout that DTensor's backward would otherwise change — as its
    RMSNorm over a sharded last axis sequence-shards the gradient, whose
    strided products then take minutes to plan."""
    r = _RULES.get()
    if r is None or not is_dtensor(x) or not x.requires_grad:
        return x
    want = placements(r.mesh, sanitize(r.mesh, _resolve(r, spec), x.shape))
    return _PinGrad.apply(x, want)


def local_apply(fn, args: tuple, in_specs: tuple, out_specs):
    """``fn`` run on each rank's local shards: the region where model code
    works on plain tensors inside a sharded program (the reference leaves
    such regions to GSPMD; DTensor has no sharding strategy for some of
    their ops, and none that is cheap to search for others).

    Without active rules or DTensor arguments, ``fn(*args)`` itself. Else
    each DTensor argument is redistributed to its spec in ``in_specs``
    (``"data"`` resolved, non-dividing entries dropped; plain arguments
    pass through) and handed over as its local shard; each tensor output
    is wrapped as a DTensor laid out by ``(spec, global shape[, partial
    axes])`` in ``out_specs`` — partial along the mesh axes named last,
    whose ranks' outputs sum to the value — or ``None`` for a non-tensor
    output. ``fn`` must compute
    its output shards from its input shards alone: the specs state the
    layout that makes that true. The region is differentiable: its work
    is split along every mesh axis that shards some input, so an input
    replicated along such an axis gets a gradient that is partial there."""
    r = _RULES.get()
    if r is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial, Shard
    mesh = r.mesh
    placed = [constrain(a, *spec) if is_dtensor(a) else a
              for a, spec in zip(args, in_specs)]
    split = {i for a in placed if is_dtensor(a)
             for i, pl in enumerate(a.placements) if isinstance(pl, Shard)}
    # the ranks that split the region's work: the cost count
    # (repro_torch.launch.flop_cost) counts each op on the shards that
    # many times, forward and backward, to count the global work
    share = 1
    for i in split:
        share *= mesh.shape[i]
    local = []
    for a in placed:
        if is_dtensor(a):
            a = _Enter.apply(a, tuple(
                Partial() if i in split and not isinstance(pl, Shard) else pl
                for i, pl in enumerate(a.placements)))
            setattr(a, COST_SHARE, share)
        local.append(a)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    if single:
        out_specs = (out_specs,)
    wrapped = []
    for o, so in zip(outs, out_specs):
        if so is None:
            wrapped.append(o)
            continue
        spec, shape, *partial = so
        shape = tuple(shape)
        pl = list(placements(mesh, sanitize(mesh, _resolve(r, spec), shape)))
        for axis in (partial[0] if partial else ()):
            pl[list(mesh.mesh_dim_names).index(axis)] = Partial()
        wrapped.append(_Exit.apply(o, mesh, tuple(pl), shape, share))
    return wrapped[0] if single else tuple(wrapped)


def _plain(t):
    """The plain tensor under any DTensor wrapping."""
    while getattr(t, "_local_tensor", None) is not None:
        t = t._local_tensor
    return t


def _dtensor(local, mesh, places, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


class _Enter(torch.autograd.Function):
    """A DTensor → its local shard; the gradient comes back as a DTensor
    laid out by ``grad_places``. The region's own boundary, so that the
    gradients it hands on are plain DTensors in every torch release (2.11's
    ``to_local`` handed on a DTensor wrapping a DTensor)."""

    @staticmethod
    def forward(ctx, x, grad_places):
        ctx.mesh, ctx.places, ctx.shape = x.device_mesh, grad_places, x.shape
        return _plain(x).view_as(_plain(x))

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return _dtensor(_plain(g), ctx.mesh, ctx.places, ctx.shape), None


class _Exit(torch.autograd.Function):
    """A local shard → a DTensor laid out by ``places`` (partial entries:
    the ranks' shards sum to the value); its gradient comes back as the
    local shard of a gradient laid out alike (partial read as
    replicated)."""

    @staticmethod
    def forward(ctx, local, mesh, places, shape, share):
        from torch.distributed.tensor import Partial, Replicate
        ctx.mesh, ctx.share = mesh, share
        ctx.places = tuple(Replicate() if isinstance(p, Partial) else p
                           for p in places)
        with torch.no_grad():
            return _dtensor(local, mesh, places, shape)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            if tuple(g.placements) != ctx.places:
                g = g.redistribute(ctx.mesh, ctx.places)
            g = _plain(g).view_as(_plain(g))
            setattr(g, COST_SHARE, ctx.share)
            return g, None, None, None, None


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# spec ↔ DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements (one per mesh dimension) of a spec: a tensor
    dimension sharded over ``("pod", "data")`` becomes ``Shard(d)`` on both
    mesh dimensions; an axis no entry names is ``Replicate()``. A tuple
    entry must list its axes in mesh order (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def spec_from_placements(mesh, places, ndim: int) -> tuple:
    """The spec of DTensor placements: the inverse of :func:`placements`
    (an entry of one axis is its name, of several a tuple in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    entries: list = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, places):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl!r} has no spec")
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in entries)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def moe_policy(cfg, model_size: int) -> str:
    """'ep' (experts over model) or 'tp' (d_ff over model). Expert counts
    are padded (cfg.moe_pad_experts) precisely so EP applies."""
    if cfg.num_experts and cfg.num_experts_padded % model_size == 0:
        return "ep"
    return "tp"


# Per-device budget above which weights must also shard over the data axes
# (ZeRO-3). Below it, weights replicate across data and shard only over
# model. Optimizer moments always shard over (data, model) (ZeRO-1).
FSDP_THRESHOLD_BYTES = 10 * 2 ** 30


def fsdp_policy(cfg, model_size: int,
                threshold: int = FSDP_THRESHOLD_BYTES) -> bool:
    per_device = cfg.param_count() * 2 / model_size      # bf16
    return per_device > threshold


def _dense_layer_specs(cfg, r: Rules, d) -> dict:
    kv = r.over_model(cfg.num_kv_heads)
    hq = r.over_model(cfg.num_heads * cfg.head_dim)
    attn = {
        "wq": (d, hq),
        "wk": (d, kv),
        "wv": (d, kv),
        "wo": (hq, d),
        "ln": (None,),
    }
    if cfg.qk_norm:
        attn["q_norm"] = (None,)
        attn["k_norm"] = (None,)
    ff = r.over_model(cfg.d_ff)
    mlp = {
        "wg": (d, ff),
        "wu": (d, ff),
        "wd": (ff, d),
        "ln": (None,),
    }
    return {"attn": attn, "mlp": mlp}


def _moe_layer_specs(cfg, r: Rules, d) -> dict:
    if moe_policy(cfg, r.model_size) == "ep":
        e_ax, f_ax, fin = r.model_axis, None, None
    else:
        e_ax, f_ax = None, r.over_model(cfg.d_ff)
        fin = f_ax
    return {
        "router": (d, None),
        "wg": (e_ax, d, f_ax),
        "wu": (e_ax, d, f_ax),
        "wd": (e_ax, fin, d),
        "ln": (None,),
    }


def _ssm_layer_specs(cfg, r: Rules, d) -> dict:
    din = r.over_model(cfg.ssm_d_inner)
    bc = r.over_model(cfg.ssm_groups * cfg.ssm_state)
    h = r.over_model(cfg.ssm_num_heads)
    conv = din if din and bc else None
    return {
        "wz": (d, din),
        "wx": (d, din),
        "wB": (d, bc),
        "wC": (d, bc),
        "wdt": (d, None),
        "conv_w": (None, conv),
        "conv_b": (conv,),
        "A_log": (h,),
        "dt_bias": (h,),
        "D_skip": (h,),
        "gnorm": (din,),
        "out_proj": (din, d),
        "ln": (None,),
    }


def param_specs(cfg, rules: Rules, fsdp: bool | None = None) -> dict:
    """Spec tree matching the port's ``init_params`` tree: ``"layers"``
    holds the one spec tree that every layer's group takes (an SSM layer's
    group is the Mamba2 block itself, where the reference nests it under
    ``"ssm"``).

    ``fsdp=None`` applies the size-aware policy (:func:`fsdp_policy`);
    ``fsdp=True`` forces ZeRO-3 weight sharding over the data axes (used
    unconditionally for optimizer moments — ZeRO-1)."""
    r = rules
    if fsdp is None:
        fsdp = fsdp_policy(cfg, r.model_size)
    m = r.model_axis
    d = "data" if fsdp else None
    specs: dict[str, Any] = {}
    if cfg.frontend == "tokens":
        specs["embed"] = (m, d)
    if cfg.family in ("dense", "audio", "vlm"):
        specs["layers"] = _dense_layer_specs(cfg, r, d)
    elif cfg.family == "moe":
        lay = _dense_layer_specs(cfg, r, d)
        lay.pop("mlp")
        lay["moe"] = _moe_layer_specs(cfg, r, d)
        specs["layers"] = lay
    elif cfg.family == "ssm":
        specs["layers"] = _ssm_layer_specs(cfg, r, d)
    elif cfg.family == "hybrid":
        specs["layers"] = _ssm_layer_specs(cfg, r, d)
        specs["shared_attn"] = _dense_layer_specs(cfg, r, d)
    else:
        raise ValueError(cfg.family)
    specs["final_norm"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (d, m)
    return specs


def batch_specs(cfg, rules: Rules, kind: str) -> dict:
    """Input specs for a shape kind ('train'|'prefill'|'decode')."""
    b = rules.batch
    if cfg.frontend == "tokens":
        specs = {"tokens": (b, None)}
    else:
        specs = {"embeddings": (b, None, None)}
        if cfg.m_rope:
            specs["positions3"] = (None, b, None)
    if kind == "train":
        specs["labels"] = (b, None)
    return specs


def cache_specs(cfg, rules: Rules, *, seq_parallel: bool = False) -> dict:
    """KV/SSM cache specs (leading layer axis kept).

    * ``seq_parallel`` (long-context, batch=1): KV sequence shards over the
      data axes — decode attention combines per-shard partial products.
    * KV heads shard over ``model`` when divisible; otherwise the
      *sequence* shards over ``model`` instead.
    """
    b = rules.batch
    kv_ax = rules.over_model(cfg.num_kv_heads)
    seq_axes: list = []
    if seq_parallel:
        seq_axes += list(rules.data_axes)
    if kv_ax is None:
        seq_axes.append(rules.model_axis)
    # one axis is named bare, as a PartitionSpec normalises ("data",)
    seq_sp = (None if not seq_axes else seq_axes[0] if len(seq_axes) == 1
              else tuple(seq_axes))
    bat_ax = None if seq_parallel else b
    specs = {}
    if cfg.num_attn_layers:
        specs["k"] = (None, bat_ax, seq_sp, kv_ax, None)
        specs["v"] = (None, bat_ax, seq_sp, kv_ax, None)
        specs["pos"] = ()
    if cfg.family in ("ssm", "hybrid"):
        specs["ssm_state"] = (None, bat_ax,
                              rules.over_model(cfg.ssm_num_heads), None, None)
        specs["conv_buf"] = (None, bat_ax, None, None)
        if "pos" not in specs:
            specs["pos"] = ()
    return specs


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------

_LAYER_INDEX = re.compile(r"^layers\.\d+\.")


def named_specs(specs: dict, named) -> dict:
    """{parameter name: spec} for a tree's ``named_parameters()`` pairs
    (``layers.<i>.attn.wq`` reads ``specs["layers"]["attn"]["wq"]``)."""
    out = {}
    for name, _ in named:
        key = _LAYER_INDEX.sub("layers.", name)
        node = specs
        for part in key.split("."):
            node = node[part]
        out[name] = node
    return out


def local_shape_offset(shape, mesh, places) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` laid out by ``places`` (computed on real tensors, also while
    a fake mode traces)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(shape, mesh, places)


def shard_tensor(t: torch.Tensor, mesh, spec: tuple):
    """``t`` as a DTensor laid out by ``spec`` (non-dividing entries
    dropped): each rank keeps its own slice of the same global tensor. A
    fake ``t`` (a dry-run's abstract value) becomes a DTensor over an
    empty fake shard of the local shape, with no collective."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(mesh, sanitize(mesh, spec, t.shape))
    if isinstance(t, FakeTensor):
        shape, _ = local_shape_offset(t.shape, mesh, pl)
        return DTensor.from_local(t.new_empty(shape), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return distribute_tensor(t, mesh, pl)


def shard_params(params, mesh, specs: dict):
    """Replace every parameter of a ParamGroup tree by a DTensor parameter
    laid out by ``specs`` (see :func:`param_specs`), keeping its
    ``requires_grad``; returns the same tree."""
    from torch import nn
    table = named_specs(specs, params.named_parameters())
    for name, p in list(params.named_parameters()):
        *path, leaf = name.split(".")
        owner = params
        for part in path:
            owner = getattr(owner, part)
        owner.register_parameter(leaf, nn.Parameter(
            shard_tensor(p.detach(), mesh, table[name]),
            requires_grad=p.requires_grad))
    return params


def shard_opt_state(state, mesh, specs: dict):
    """An :class:`~repro_torch.optim.adamw.OptState` with its moments laid
    out by ``specs`` (a :func:`param_specs` tree; ZeRO-1 passes
    ``fsdp=True``); the step counter stays a plain (replicated) tensor."""
    table = named_specs(specs, state.mu.items())
    return type(state)(
        step=state.step,
        mu={k: shard_tensor(v, mesh, table[k]) for k, v in state.mu.items()},
        nu={k: shard_tensor(v, mesh, table[k]) for k, v in state.nu.items()})


def shard_cache(cache: dict, mesh, specs: dict) -> dict:
    """A serving cache (``init_cache``) with its tensors laid out by
    ``specs`` (:func:`cache_specs`); ``pos`` stays an int."""
    return {k: (shard_tensor(v, mesh, specs[k])
                if isinstance(v, torch.Tensor) else v)
            for k, v in cache.items()}
