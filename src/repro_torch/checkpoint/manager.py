"""Fault-tolerant checkpointing: atomic, keep-K, CRC-verified.

The counterpart of the JAX package's ``checkpoint/manager.py``, with its
layout per step::

    <dir>/step_000000123.tmp/   (written first)
        manifest.json           (leaf paths, shapes, dtypes, CRCs, step)
        arr_00000.npy ...       (one file per leaf, copied to the host)
    <dir>/step_000000123/       (os.replace after the manifest's fsync —
                                 a crashed writer never corrupts a
                                 restorable checkpoint)

A tree is a nest of dicts (in sorted key order, as the reference's tree
flattening takes them), lists, tuples (an ``OptState`` by its field
names), modules (their ``named_parameters()``) and tensors; a leaf's path
joins the keys with ``/``, so a dict of tensors is written as the
reference writes it. A bfloat16 tensor, which numpy has no dtype
for, is stored as its raw 16 bits (``uint16``) under its logical dtype
``bfloat16`` and viewed back on restore. A CRC32 per leaf catches torn or
bit-rotted files before they poison training.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["CheckpointManager"]


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str,
                                                             torch.Tensor]]:
    """(path, tensor) for every leaf of ``tree``, in a fixed order."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(join(name), p) for name, p in tree.named_parameters()]
    if hasattr(tree, "_fields"):                 # a NamedTuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):         # sorted keys, as the reference's
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree)}, "
                        "not a tensor")
    out = []
    for key, sub in items:
        out.extend(_flatten_with_paths(sub, join(key)))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:     # raw bits: numpy has no bfloat16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
            arr = _host_array(leaf)
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "path": path, "file": fname, "shape": list(arr.shape),
                "dtype": _dtype_name(leaf.dtype),
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):       # re-save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
        self._gc()
        return final

    def _gc(self):
        ckpts = self.all_steps()
        for step in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{step:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d[5:]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Load step ``step`` into the tensors of ``like`` (same paths and
        shapes; each leaf copied in place, cast to its dtype on its
        device). Returns (``like``, the saved ``extra``)."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        loaded = []
        for path, leaf in _flatten_with_paths(like):
            entry = by_path.get(path)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf '{path}'")
            arr = np.load(os.path.join(d, entry["file"]))
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != entry["crc"]:
                raise IOError(f"CRC mismatch for '{path}' — corrupt "
                              f"checkpoint {d}")
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"shape mismatch for '{path}': "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            loaded.append((leaf, _from_host(arr, entry["dtype"])))
        # every leaf is read and checked before the first is overwritten
        with torch.no_grad():
            for leaf, value in loaded:
                leaf.copy_(value)
        return like, manifest["extra"]

    def restore_latest(self, like: Any):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like)
        return step, tree, extra
