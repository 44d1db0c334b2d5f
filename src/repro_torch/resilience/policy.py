"""Resilience policy: the switchboard the serving stack consults.

One :class:`ResiliencePolicy` bundles the three guard layers —
boundary validation, the degradation ladder (+ output finiteness
check), and the circuit breaker — behind per-layer switches, plus a
bounded incident log. ``Planner`` and ``SpGEMMServer`` default to the
process-global policy (:func:`get_policy`); benchmarks construct a
disabled one to measure the guards' overhead, and tests construct
isolated ones with injected clocks.

The **degradation ladder** is the ordered list of schemes a failing
execution falls back through, ending at the identity row-wise oracle
(the bit-exactness reference every other tier is tested against)::

    pallas ─▶ fixed (gather/scatter clusterwise) ─▶ rowwise identity
    hierarchical / variable / fixed ─▶ rowwise identity
    rowwise ─▶ (nothing left: the failure re-raises)

Fallback rungs run with ``reorder="original"`` — a failing request must
not pay a reorder on its recovery path.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import deque
from typing import Optional

from repro_torch.resilience.breaker import CircuitBreaker

__all__ = ["FALLBACK_LADDER", "fallback_chain", "Incident", "Watermarks",
           "ResiliencePolicy", "get_policy", "set_policy", "reset_policy"]


# scheme -> ordered fallback rungs (each strictly simpler than the last)
FALLBACK_LADDER: dict[str, tuple[str, ...]] = {
    "pallas": ("fixed", "rowwise"),
    "hierarchical": ("fixed", "rowwise"),
    "variable": ("fixed", "rowwise"),
    "fixed": ("rowwise",),
    "rowwise": (),
}


def fallback_chain(scheme: str) -> tuple[str, ...]:
    """The rungs below ``scheme`` (empty for the identity oracle)."""
    return FALLBACK_LADDER.get(scheme, ("rowwise",))


@dataclasses.dataclass(frozen=True)
class Incident:
    """One recorded degradation event (bounded log on the policy)."""

    fingerprint: str
    workload: str
    scheme: str          # the failing scheme
    reorder: str         # the failing plan's reorder
    site: str            # failure classification: exception | nonfinite
    error: str           # "Type: message" of the cause
    fallback: str        # rung that recovered the request ("" if none)
    at_unix: float


@dataclasses.dataclass(frozen=True)
class Watermarks:
    """Queue-depth thresholds driving the *proactive* degradation ladder.

    The reactive ladder (:data:`FALLBACK_LADDER`) fires after a failure;
    these watermarks fire *before* one: when the serving front-end's
    bounded queue fills past ``high`` (as a fraction of capacity), new
    — not-yet-hot — fingerprints are admitted on the ladder's floor
    (identity row-wise, zero preprocessing) instead of paying plan
    materialization the queue cannot afford; the downgrade pressure
    clears once the queue drains below ``low`` (hysteresis, so the
    ladder does not flap at the threshold). Fingerprints the reuse
    estimator already grades hot keep their full plans even under
    pressure — their preprocessing amortizes regardless.
    """

    high: float = 0.75       # fill fraction that turns downgrades on
    low: float = 0.50        # fill fraction that turns them back off

    def __post_init__(self):
        if not 0.0 <= self.low <= self.high <= 1.0:
            raise ValueError(
                f"need 0 <= low <= high <= 1, got low={self.low}, "
                f"high={self.high}")


class ResiliencePolicy:
    """Guard configuration + quarantine + incident log.

    Args:
      validate: run operand validation at the ``submit`` boundary.
      ladder: arm the degradation ladder (and the output finiteness
        guard) around ``Planner.execute``.
      breaker: the :class:`CircuitBreaker` quarantining failing
        (fingerprint, scheme, variant) triples; ``None`` constructs a
        default one. The breaker only acts when ``ladder`` is on (a
        failure must be *observed* to be quarantined).
      max_incidents: incident-log bound.
      watermarks: the queue-fill :class:`Watermarks` at which the
        serving front-end proactively downgrades cold fingerprints to
        the ladder's identity floor (``None`` constructs the defaults).
    """

    def __init__(self, *, validate: bool = True, ladder: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 max_incidents: int = 256,
                 watermarks: Optional[Watermarks] = None):
        self.validate = bool(validate)
        self.ladder = bool(ladder)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.watermarks = (watermarks if watermarks is not None
                           else Watermarks())
        self.incidents: deque[Incident] = deque(maxlen=max_incidents)
        self.fallbacks = 0       # executions recovered by a lower rung
        self.rejects = 0         # operands rejected at the boundary
        self.sheds = 0           # requests shed at the admission boundary
        self.downgrades = 0      # proactive watermark-driven downgrades
        # operands whose deep content checks already passed. Serving
        # treats submitted operands as immutable (the exec cache
        # re-serves packed operands on exactly that assumption), so the
        # O(nnz) scans run once per object, not once per request — the
        # same amortization contract as plan/exec caching. Keyed by id()
        # with the object as the weak value: a hit proves the object is
        # alive, so its id cannot have been reused.
        self._validated: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()

    @classmethod
    def disabled(cls) -> "ResiliencePolicy":
        """All guards off — the raw serving path, the baseline the guards'
        overhead is measured against."""
        return cls(validate=False, ladder=False)

    @property
    def enabled(self) -> bool:
        return self.validate or self.ladder

    # -- validation memo -----------------------------------------------------

    def is_validated(self, obj) -> bool:
        """Whether ``obj`` (this exact object) already passed its deep
        content checks. Pairwise shape compatibility is re-checked on
        every request regardless."""
        return self._validated.get(id(obj)) is obj

    def mark_validated(self, obj) -> None:
        try:
            self._validated[id(obj)] = obj
        except TypeError:       # not weak-referenceable: never memoized
            pass

    # -- breaker façade (keyed the way the planner keys) ---------------------

    @staticmethod
    def triple(fingerprint: str, scheme: str, variant: str) -> tuple:
        """The quarantine key: ``variant`` is the plan's reorder (the
        axis along which two same-scheme plans can differ)."""
        return (fingerprint, scheme, variant)

    def allows(self, fingerprint: str, scheme: str, variant: str) -> bool:
        if not self.ladder:
            return True
        return self.breaker.allows(self.triple(fingerprint, scheme,
                                               variant))

    def record_incident(self, *, fingerprint: str, workload: str,
                        scheme: str, reorder: str, site: str,
                        error: BaseException | str,
                        fallback: str = "") -> Incident:
        msg = (f"{type(error).__name__}: {error}"
               if isinstance(error, BaseException) else str(error))
        inc = Incident(fingerprint=fingerprint, workload=workload,
                       scheme=scheme, reorder=reorder, site=site,
                       error=msg, fallback=fallback, at_unix=time.time())
        self.incidents.append(inc)
        if fallback:
            self.fallbacks += 1
        return inc

    @property
    def stats(self) -> dict:
        return {"fallbacks": self.fallbacks, "rejects": self.rejects,
                "sheds": self.sheds, "downgrades": self.downgrades,
                "incidents": len(self.incidents),
                "quarantined": len(self.breaker.open_keys()),
                "breaker": self.breaker.stats}


_POLICY: Optional[ResiliencePolicy] = None


def get_policy() -> ResiliencePolicy:
    """The process-global policy ``Planner``/``SpGEMMServer`` default to
    (guards on)."""
    global _POLICY
    if _POLICY is None:
        _POLICY = ResiliencePolicy()
    return _POLICY


def set_policy(policy: ResiliencePolicy) -> ResiliencePolicy:
    global _POLICY
    _POLICY = policy
    return policy


def reset_policy() -> None:
    global _POLICY
    _POLICY = None
