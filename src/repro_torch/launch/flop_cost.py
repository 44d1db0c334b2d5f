"""Trip-exact FLOP/byte accounting of a traced PyTorch function: the
counterpart of the JAX package's ``launch/jaxpr_cost.py``.

The reference walks a post-AD jaxpr and multiplies scan bodies by their
static length. The port runs the function itself under
:class:`~torch._subclasses.fake_tensor.FakeTensorMode` (nothing is
allocated, nothing computed) with a dispatch mode over its aten ops. An
eager program unrolls every loop, so each op it runs is counted as often
as it runs — including the backward pass and ``torch.utils.checkpoint``'s
recompute, when the traced function runs autograd inside the mode. Under
DTensor the mode sees each op at its global shapes (the reference's
jaxpr is global too) and each collective DTensor issues. Inside a
:func:`~repro_torch.distributed.sharding.local_apply` region (and in its
backward pass) ops run on plain local shards: each such op counts times
the number of ranks that split the region's work, which its shards carry
(an op inherits the largest share of its tensor arguments), so that a
sharded program counts the global work too.

Counts:

* ``flops``    — the matmul-class ops of ``torch.utils.flop_counter``'s
  registry (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, and the
  einsums that lower to them), by its formulas: so a count equals
  :class:`~torch.utils.flop_counter.FlopCounterMode`'s on the same run.
* ``bytes``    — fusion-modelled HBM traffic, the reference's
  ``_MEM_PRIMS`` classes: matmuls and reductions move their operands and
  results; gathers twice their result; scatters twice their update; sort,
  top-k and cumulative ops their operands and results; elementwise and
  layout ops nothing (a fused chain's traffic is its producers' and
  consumers').
* ``bytes_ub`` — every op's operands and results (fusion-unaware bound).

:func:`trace` also keeps the collectives (see
:mod:`repro_torch.launch.comm_stats`) and, optionally, the peak of the
bytes that the traced ops' outputs hold alive — each rank's local shard
for a DTensor.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.distributed.sharding import COST_SHARE
from repro_torch.launch.comm_stats import collective_op

__all__ = ["trace_cost", "trace", "Trace", "abstract", "fake_mode"]


def _names(*names) -> frozenset:
    return frozenset(names)


_MATMUL = _names("mm", "addmm", "bmm", "baddbmm", "convolution",
                 "_convolution", "convolution_backward", "_scaled_mm",
                 "cudnn_convolution")
_REDUCE = _names("sum", "mean", "amax", "amin", "max", "min", "prod",
                 "argmax", "argmin", "logsumexp", "var", "var_mean", "std",
                 "std_mean", "norm", "linalg_vector_norm", "any", "all",
                 "_softmax", "_log_softmax", "_softmax_backward_data",
                 "_log_softmax_backward_data", "nansum")
_SORT = _names("sort", "topk", "cumsum", "cumprod", "cummax", "cummin",
               "logcumsumexp", "kthvalue", "median", "_cummax_helper",
               "_cummin_helper", "cumsum_")
_GATHER = _names("index", "index_select", "embedding", "gather",
                 "take_along_dim")
# scatter-class op → position of its update tensor
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "_unsafe_index_put": 2, "scatter": 3, "scatter_": 3,
            "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
            "scatter_reduce_": 3, "slice_scatter": 1, "select_scatter": 1,
            "index_add": 3, "index_add_": 3, "index_copy": 3,
            "index_copy_": 3, "embedding_dense_backward": 0,
            "masked_scatter": 2, "masked_scatter_": 2}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return int(math.prod(t.shape)) * t.element_size()
    return 0


def _all_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(_nbytes(x) for x in leaves)


def _share(tree) -> int:
    """The ranks that split an op's work: 1 but for an op on the shards
    of a local_apply region."""
    share = 1
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            share = max(share, getattr(x, COST_SHARE, 1))
    return share


def _local(t):
    return getattr(t, "_local_tensor", t)


class _Live:
    """Live bytes of the storages the traced ops' outputs hold (a DTensor
    by its local shard); storages that existed before the trace are not
    counted. ``peak`` is the most held at once."""

    def __init__(self, external):
        self.external = set()
        for t in external:
            key = self._key(t)
            if key is not None:
                self.external.add(key)
        self.refs: dict = {}
        self.sizes: dict = {}
        self.live = 0
        self.peak = 0

    @staticmethod
    def _key(t):
        t = _local(t)
        if not isinstance(t, torch.Tensor):
            return None
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return None

    def track(self, t) -> None:
        t = _local(t)
        key = self._key(t)
        if key is None or key in self.external:
            return
        if key not in self.refs:
            self.refs[key] = 0
            self.sizes[key] = t.untyped_storage().nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        self.refs[key] -= 1
        if self.refs[key] == 0:
            self.live -= self.sizes.pop(key)
            del self.refs[key]


class _CostMode(TorchDispatchMode):
    def __init__(self, live: _Live | None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.bytes_ub = 0
        self.collectives: list[tuple[str, int]] = []
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func.overloadpacket not in self.registry
                and func is not torch.ops.prim.device.default):
            # a composite op that reaches the mode whole (as under
            # inference_mode) is counted by the ops it decomposes into,
            # as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        op = collective_op(func)
        if op is not None:
            self.collectives.append((op, _all_bytes(out)))
        elif func.namespace == "aten":
            share = _share((args, kwargs))
            self._count(func, args, kwargs, out, share)
            if share > 1:
                for t in tree_flatten(out)[0]:
                    if isinstance(t, torch.Tensor):
                        setattr(t, COST_SHARE, share)
        if self.live is not None:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.live.track(t)
        return out

    def _count(self, func, args, kwargs, out, share) -> None:
        name = func._schema.name.split("::")[-1]
        packet = func.overloadpacket
        if packet in self.registry:
            self.flops += share * int(self.registry[packet](
                *args, **kwargs, out_val=out))
        ebytes = _all_bytes((args, kwargs)) + _all_bytes(out)
        self.bytes_ub += share * ebytes
        if name in _MATMUL or name in _REDUCE or name in _SORT:
            self.bytes += share * ebytes
        elif name in _GATHER:
            # reads only the gathered elements; the table is not streamed
            self.bytes += share * 2 * _all_bytes(out)
        elif name in _SCATTER:
            # an in-place update touches the update's elements
            i = _SCATTER[name]
            upd = args[i] if len(args) > i else None
            if isinstance(upd, (list, tuple)):
                upd = None
            if isinstance(upd, torch.Tensor):
                self.bytes += share * 2 * _nbytes(upd)
            elif name.startswith("scatter") and len(args) > 2:
                # a scalar scattered at each index
                self.bytes += share * 2 * int(math.prod(args[2].shape)) \
                    * args[0].element_size()


@dataclasses.dataclass
class Trace:
    flops: int
    bytes: int
    bytes_ub: int
    collectives: list          # (op, per-rank bytes) in issue order
    peak_bytes: int | None     # None unless traced with memory=True

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_ub": self.bytes_ub}


def _tensors(tree) -> list:
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif hasattr(x, "_fields"):                  # a NamedTuple state
            out.extend(_tensors(tuple(x)))
    return out


def _fake_mode(tensors):
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = detect_fake_mode([_local(t) for t in tensors])
    return mode or FakeTensorMode(allow_non_fake_inputs=True)


def trace(fn, *args, memory: bool = False) -> Trace:
    """Run ``fn(*args)`` once under fake tensors and count it. Arguments
    may be fake tensors (or DTensors over them) from one
    :class:`FakeTensorMode`, modules holding such parameters, or real
    tensors, which the mode treats as fake."""
    tensors = _tensors(args)
    mode = _fake_mode(tensors)
    live = _Live(tensors) if memory else None
    counter = _CostMode(live)
    with mode, counter:
        fn(*args)
    return Trace(counter.flops, counter.bytes, counter.bytes_ub,
                 counter.collectives, live.peak if live else None)


def trace_cost(fn, *abstract_args) -> dict:
    """{'flops', 'bytes' (fusion-modelled), 'bytes_ub'} of one execution of
    ``fn(*abstract_args)``; no device allocation."""
    return trace(fn, *abstract_args).cost()


_SHARED: list = []


def fake_mode():
    """The FakeTensorMode that :func:`abstract` makes its tensors in."""
    if not _SHARED:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _SHARED.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _SHARED[0]


def abstract(shape, dtype=torch.float32, *, mode=None):
    """A fake tensor of ``shape`` and ``dtype`` (the port's
    ``ShapeDtypeStruct``), in ``mode`` or the shared :func:`fake_mode`."""
    with mode or fake_mode():
        return torch.empty(tuple(shape), dtype=dtype)
