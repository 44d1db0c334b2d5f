"""Elastic scaling + straggler/failure handling (simulated control plane).

A numpy-only copy of the JAX package's ``distributed/elastic.py``. One
process drives the card, so multi-host failure handling is modeled at
the layer that *is* portable: deterministic shard assignment, re-mesh
planning, and step-skip bookkeeping. On a real cluster the same objects are
driven by the cluster manager's membership events.

* :func:`plan_remesh` — given a device loss (e.g. 512 → 448 healthy chips),
  pick the largest (data, model)-factorable healthy sub-mesh, keeping the
  model axis intact (TP groups must not be split across failures) and
  shrinking data parallelism instead.
* :func:`reassign_shards` — stateless (step, shard) data indexing means a
  re-mesh is a pure renumbering; returns the new shard→host map.
* :class:`StragglerMonitor` — robust-z-score step-time outlier detection;
  flags hosts whose step time exceeds ``threshold`` MADs for ``patience``
  consecutive steps (on a cluster, the standard mitigation is checkpoint +
  evict + re-mesh, which is exactly plan_remesh + CheckpointManager).
* :class:`NaNGuard` — poisoned-step bookkeeping (skip update, keep count;
  abort after ``max_consecutive``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["plan_remesh", "reassign_shards", "StragglerMonitor", "NaNGuard"]


def plan_remesh(healthy_devices: int, model_size: int,
                pod_size: int | None = None) -> tuple[int, ...]:
    """Largest usable (data, model) or (pod, data, model) mesh shape.

    The model axis is preserved exactly; data shrinks to
    floor(healthy/model); if pods are in play, the pod axis shrinks first
    (whole-pod eviction is the realistic failure domain for DCN-connected
    slices)."""
    if healthy_devices < model_size:
        raise ValueError("fewer healthy devices than one model group — "
                         "cannot re-mesh without re-sharding the model axis")
    if pod_size is not None:
        pods = healthy_devices // pod_size
        if pods >= 2:
            data = pod_size // model_size
            return (pods, data, model_size)
        healthy_devices = min(healthy_devices, pod_size)
    data = healthy_devices // model_size
    return (data, model_size)


def reassign_shards(num_shards: int, healthy_hosts: list[int]) -> dict[int, int]:
    """shard index → host id, round-robin over healthy hosts (deterministic,
    so every host computes the same map without coordination)."""
    return {s: healthy_hosts[s % len(healthy_hosts)]
            for s in range(num_shards)}


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 4.0        # robust z-score (MAD units)
    patience: int = 3
    window: int = 64

    def __post_init__(self):
        self._times: dict[int, list[float]] = {}
        self._strikes: dict[int, int] = {}

    def record(self, host: int, step_time: float) -> None:
        buf = self._times.setdefault(host, [])
        buf.append(step_time)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> list[int]:
        all_times = [t for v in self._times.values() for t in v]
        if len(all_times) < 8:
            return []
        med = float(np.median(all_times))
        mad = float(np.median(np.abs(np.asarray(all_times) - med))) or 1e-9
        out = []
        for host, buf in self._times.items():
            z = (buf[-1] - med) / (1.4826 * mad)
            if z > self.threshold:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes.get(host, 0) >= self.patience:
                out.append(host)
        return out


@dataclasses.dataclass
class NaNGuard:
    max_consecutive: int = 10

    def __post_init__(self):
        self.consecutive = 0
        self.total_skipped = 0

    def check(self, loss: float) -> bool:
        """True → apply the update; False → skip this step."""
        if np.isfinite(loss):
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.total_skipped += 1
        if self.consecutive >= self.max_consecutive:
            raise FloatingPointError(
                f"{self.consecutive} consecutive non-finite losses — "
                "halting so the last good checkpoint can be restored")
        return False
