"""Production mesh construction over ``torch.distributed``.

The counterpart of the JAX package's ``launch/mesh.py``. A FUNCTION, not a
module-level constant: importing this module touches no process group.

``make_production_mesh`` needs no cluster: with no process group running
it starts PyTorch's ``fake`` backend, one process standing for every rank
of the 256- or 512-device mesh. Collectives on it move nothing; the
dry-run (:mod:`repro_torch.launch.dryrun`) traces fake tensors over it to
count FLOPs, bytes and the collectives the sharding rules insert.
``make_test_mesh`` lays a small mesh over whatever process group is
running: ``gloo`` rank processes, or one NCCL rank on the card.
"""
from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_test_mesh", "ensure_fake_world"]


def ensure_fake_world(world_size: int) -> None:
    """A process group of ``world_size`` ranks: PyTorch's ``fake`` backend
    (this process is rank 0) when none is running, or the running one when
    it already has that size. A running fake group of another size is
    replaced; any other process group of another size raises."""
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group of "
                f"{dist.get_world_size()} ranks is running; the mesh needs "
                f"{world_size}")
        dist.destroy_process_group()
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:          # a torch without the fake backend
        raise RuntimeError(
            "this torch has no 'fake' process-group backend; the "
            f"{world_size}-rank production mesh needs it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _make_mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """16×16 single pod (256 devices) or 2×16×16 multi-pod (512 devices),
    over the fake backend unless a process group of that size runs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ensure_fake_world(math.prod(shape))
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, *, pod: int = 0,
                   device_type="cpu"):
    """Small mesh over the running process group (its world size must be
    the mesh's size)."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"),
                          device_type)
    return _make_mesh((data, model), ("data", "model"), device_type)
