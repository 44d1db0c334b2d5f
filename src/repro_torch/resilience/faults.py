"""Deterministic fault injection for the serving stack (chaos harness).

A :class:`FaultPlan` arms a seeded, reproducible failure schedule at the
four injection sites the serving path threads hooks through:

* ``cache_load`` — bytes read from an on-disk plan-cache entry are
  corrupted (:func:`corrupt_bytes`), modeling a truncated/bit-rotted
  npz. Exercised in :meth:`repro_torch.planner.plan_cache.PlanCache.get`.
* ``pack`` — operand packing raises
  :class:`~repro_torch.resilience.errors.FaultInjectedError`, modeling a
  malformed packed format or host OOM. Exercised in
  ``planner/service.py``'s pack paths.
* ``kernel_launch`` — the kernel wrapper raises, modeling a kernel
  build failure or a refused launch (the memory-pressure failure
  mode of Nagasaka's memory-saving SpGEMM work, arxiv 1804.01698).
  Exercised at the top of ``kernels/ops.py::bcc_spgemm_tiled`` /
  ``bcc_spgemm_sparse_c``.
* ``output`` — a NaN is poked into the produced array
  (:func:`corrupt_output`), modeling the non-finite blowup of the
  bf16-B path. Exercised in ``planner/service.py::Planner.execute``
  right before the finiteness guard.

Design rules, mirroring ``obs.trace``'s disabled-tracer contract:

1. **Strict no-op when disarmed.** Every hook first checks the
   module-level ``_ACTIVE`` slot; when no plan is armed the hook returns
   immediately (``corrupt_*`` return their input object *by identity*).
   No RNG draw, no dict lookup, no allocation.
2. **Deterministic.** The schedule is a pure function of
   ``(seed, site, per-site call ordinal)`` — the same seed replays the
   same failures, which is what lets the chaos suite assert bit-exact
   recovery under three fixed seeds.
3. **Bounded.** Each site fires at most ``max_fires`` times (default 1)
   per armed plan, so the degradation ladder's re-execution succeeds —
   like a transient production failure — unless a test explicitly asks
   for a persistent one. The ladder's identity rung additionally runs
   under :func:`suppressed` (its guaranteed-safe floor: in production
   no fault plan is armed at all).
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Iterable, Optional

import numpy as np

from repro_torch.resilience.errors import FaultInjectedError

__all__ = ["SITES", "FaultPlan", "arm", "disarm", "active_plan",
           "injected", "suppressed", "maybe_fault", "corrupt_bytes",
           "corrupt_output"]

# every injection site the serving stack threads a hook through
SITES = ("cache_load", "pack", "kernel_launch", "output")


class FaultPlan:
    """A seeded, bounded failure schedule over the injection sites.

    Args:
      seed: RNG seed — same seed, same schedule.
      sites: sites to arm (default: all of :data:`SITES`).
      rate: per-call fire probability at an armed site (1.0 = the first
        ``max_fires`` calls fire deterministically).
      max_fires: per-site cap on fires (None = unbounded; the chaos
        suite uses small caps so the ladder's retry lands clean).
    """

    def __init__(self, seed: int, sites: Optional[Iterable[str]] = None,
                 *, rate: float = 1.0, max_fires: Optional[int] = 1):
        self.seed = int(seed)
        armed = tuple(sites) if sites is not None else SITES
        unknown = sorted(set(armed) - set(SITES))
        if unknown:
            raise ValueError(f"unknown fault site(s) {unknown} — "
                             f"valid: {SITES}")
        self.sites = frozenset(armed)
        self.rate = float(rate)
        self.max_fires = max_fires
        self.calls: dict[str, int] = {s: 0 for s in SITES}
        self.fires: dict[str, int] = {s: 0 for s in SITES}
        self._lock = threading.Lock()

    def _draw(self, site: str, ordinal: int) -> float:
        """Deterministic uniform in [0, 1) from (seed, site, ordinal)."""
        h = hashlib.blake2b(f"{self.seed}|{site}|{ordinal}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def should_fire(self, site: str) -> bool:
        """Consume one trial at ``site``; True when this call fails."""
        if site not in self.sites:
            return False
        with self._lock:
            ordinal = self.calls[site]
            self.calls[site] = ordinal + 1
            if self.max_fires is not None \
                    and self.fires[site] >= self.max_fires:
                return False
            if self._draw(site, ordinal) >= self.rate:
                return False
            self.fires[site] += 1
            return True

    def total_fires(self) -> int:
        return sum(self.fires.values())


# the armed plan (None = disarmed: every hook is a strict no-op) and a
# per-thread suppression depth for the ladder's identity rung
_ACTIVE: Optional[FaultPlan] = None
_SUPPRESS = threading.local()


def arm(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide; returns it for chaining."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def disarm() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """``with injected(FaultPlan(seed)):`` — arm for the block only."""
    global _ACTIVE
    prev = _ACTIVE
    arm(plan)
    try:
        yield plan
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def suppressed():
    """Disable fault firing for the block (current thread). The
    degradation ladder runs its identity-oracle rung under this — the
    harness's guaranteed-safe floor."""
    depth = getattr(_SUPPRESS, "depth", 0)
    _SUPPRESS.depth = depth + 1
    try:
        yield
    finally:
        _SUPPRESS.depth = depth


def _armed_here() -> Optional[FaultPlan]:
    plan = _ACTIVE
    if plan is None or getattr(_SUPPRESS, "depth", 0):
        return None
    return plan


def _note_fire(site: str) -> None:
    # lazy import: metrics pulls in core.formats; faults must stay a
    # leaf module importable from anywhere in the stack
    from repro_torch.obs import metrics as obs_metrics
    obs_metrics.get_registry().counter("faults_injected", site=site).inc()


def maybe_fault(site: str) -> None:
    """Raise :class:`FaultInjectedError` when the armed plan fires at
    ``site``. Strict no-op (one global read) when disarmed."""
    if _ACTIVE is None:
        return
    plan = _armed_here()
    if plan is not None and plan.should_fire(site):
        _note_fire(site)
        raise FaultInjectedError(site, plan.fires[site])


def corrupt_bytes(site: str, raw: bytes) -> bytes:
    """Return ``raw`` damaged (truncated + bit-flipped) when the armed
    plan fires at ``site``; ``raw`` itself (identity) otherwise."""
    if _ACTIVE is None:
        return raw
    plan = _armed_here()
    if plan is None or not plan.should_fire(site):
        return raw
    _note_fire(site)
    cut = max(1, len(raw) // 2)
    damaged = bytearray(raw[:cut])
    damaged[cut // 2] ^= 0xFF
    return bytes(damaged)


def corrupt_output(site: str, out):
    """Return ``out`` with one NaN poked in when the armed plan fires at
    ``site`` (modeling a numeric blowup); ``out`` itself otherwise."""
    if _ACTIVE is None:
        return out
    plan = _armed_here()
    if plan is None or not plan.should_fire(site):
        return out
    _note_fire(site)
    bad = np.array(out, dtype=np.float32, copy=True)
    if bad.size:
        bad.flat[bad.size // 2] = np.nan
    return bad
