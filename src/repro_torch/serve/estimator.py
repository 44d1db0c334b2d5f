"""Live reuse estimation: per-fingerprint EWMA arrival rates.

The planner's break-even rule — ``reuse × gain > preprocess`` — needs a
*reuse count*, and until now serving fed it a static ``reuse_hint``
constant. This module replaces the constant with a measurement: every
request arrival decays-and-bumps a per-fingerprint rate estimate, and

    reuse_hint(fp) = clamp(rate(fp) × horizon_s, 1, max_hint)

is the expected number of recurrences over the planning horizon — the
quantity the paper's amortization envelope (preprocessing must stay
under ~20× one SpGEMM, recouped over reuse) actually depends on. A
fingerprint seen once gets hint 1 (identity plan, zero preprocessing); a
fingerprint arriving steadily graduates to hints that amortize real
preprocessing, automatically, per pattern (arxiv 2506.10356's point
that reordering benefit is workload-dependent, applied to traffic).

The decayed-mass EWMA: per fingerprint we keep ``(mass, last_t)`` and on
each arrival fold the elapsed time in first

    mass ← mass · exp(-(now - last_t)/tau) + 1      rate = mass / tau

so the rate is an exponentially-weighted arrivals-per-second with time
constant ``tau_s`` — no per-arrival log, O(1) state per fingerprint,
bounded by an LRU cap. The clock is injectable (the ``breaker.py``
pattern) so tests drive graduation deterministically.

The estimator also keeps per-fingerprint EWMA *service times* (full
plan+execute wall time, fed back by the front-end on completion) and a
global EWMA of downgraded-path times: the admission controller compares
a request's remaining deadline budget against these to shed or downgrade
before any work is wasted.
"""
from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

__all__ = ["ReuseEstimator", "DEFAULT_HORIZON_S", "DEFAULT_TAU_S"]

# planning horizon the rate is integrated over: the reuse the break-even
# rule should count is "arrivals while the plan stays hot in cache"
DEFAULT_HORIZON_S = 60.0
# EWMA time constant: ~3·tau of silence forgets a burst
DEFAULT_TAU_S = 30.0
# EWMA weight of the newest service-time sample
_SVC_EWMA = 0.3


class ReuseEstimator:
    """Per-fingerprint arrival-rate and service-time EWMAs (thread-safe).

    Args:
      horizon_s: window the reuse hint integrates the rate over.
      tau_s: EWMA time constant of the rate estimate.
      max_hint: reuse-hint ceiling (plan-cache reuse buckets are
        log-decades; hints beyond ~500 don't change decisions).
      hot_hint: hint at which a fingerprint counts as *hot* — hot
        fingerprints keep full plans even under queue pressure.
      max_fingerprints: LRU bound on tracked fingerprints.
      clock: monotonic time source (injectable for tests).
    """

    def __init__(self, *, horizon_s: float = DEFAULT_HORIZON_S,
                 tau_s: float = DEFAULT_TAU_S, max_hint: int = 500,
                 hot_hint: int = 5, max_fingerprints: int = 4096,
                 clock: Optional[Callable[[], float]] = None):
        self.horizon_s = float(horizon_s)
        self.tau_s = float(tau_s)
        self.max_hint = int(max_hint)
        self.hot_hint = int(hot_hint)
        self.max_fingerprints = int(max_fingerprints)
        self.clock = clock if clock is not None else time.monotonic
        # fp -> [mass, last_t]; OrderedDict as LRU (move on touch)
        self._rates: OrderedDict[str, list] = OrderedDict()
        # fp -> EWMA full-path service seconds
        self._service: OrderedDict[str, float] = OrderedDict()
        self._cheap_s: Optional[float] = None   # EWMA downgraded-path s
        self._lock = threading.Lock()

    # -- arrivals ------------------------------------------------------------

    def observe(self, fp: str) -> float:
        """Account one arrival of ``fp``; returns the updated rate
        (arrivals/second). Called on every submit — shed requests count
        too: the arrival rate is a property of the traffic, not of what
        the queue could absorb."""
        now = self.clock()
        with self._lock:
            ent = self._rates.get(fp)
            if ent is None:
                self._rates[fp] = [1.0, now]
                self._evict_locked(self._rates)
                return 1.0 / self.tau_s
            mass, last = ent
            mass = mass * math.exp(-max(now - last, 0.0) / self.tau_s) + 1.0
            ent[0], ent[1] = mass, now
            self._rates.move_to_end(fp)
            return mass / self.tau_s

    def rate(self, fp: str) -> float:
        """Current decayed arrival rate of ``fp`` (0.0 when untracked)."""
        now = self.clock()
        with self._lock:
            ent = self._rates.get(fp)
            if ent is None:
                return 0.0
            mass, last = ent
            return (mass * math.exp(-max(now - last, 0.0) / self.tau_s)
                    / self.tau_s)

    def reuse_hint(self, fp: str) -> int:
        """Expected arrivals over the horizon, clamped to
        ``[1, max_hint]`` — the live replacement for
        ``default_reuse_hint``."""
        expected = self.rate(fp) * self.horizon_s
        return max(1, min(self.max_hint, int(expected)))

    def is_hot(self, fp: str) -> bool:
        """Whether ``fp`` recurs often enough that its preprocessing
        amortizes even under load (the watermark downgrade skips it)."""
        return self.reuse_hint(fp) >= self.hot_hint

    # -- service times (deadline feasibility) --------------------------------

    def note_service(self, fp: str, seconds: float, *,
                     downgraded: bool = False) -> None:
        """Fold one completed request's wall time into the EWMAs. The
        downgraded path feeds the *global* cheap-path estimate (its cost
        is scheme-, not pattern-, dominated)."""
        s = float(seconds)
        if not (s >= 0.0 and math.isfinite(s)):
            return
        with self._lock:
            if downgraded:
                self._cheap_s = (s if self._cheap_s is None else
                                 (1 - _SVC_EWMA) * self._cheap_s
                                 + _SVC_EWMA * s)
                return
            prev = self._service.get(fp)
            self._service[fp] = (s if prev is None else
                                 (1 - _SVC_EWMA) * prev + _SVC_EWMA * s)
            self._service.move_to_end(fp)
            self._evict_locked(self._service)

    def predicted_service_s(self, fp: str) -> Optional[float]:
        """EWMA full-path (plan+execute) seconds for ``fp``, or ``None``
        before the first completion — an unknown cost never sheds."""
        with self._lock:
            return self._service.get(fp)

    def predicted_cheap_s(self) -> Optional[float]:
        """EWMA downgraded-path (identity rung) seconds, pattern-global."""
        with self._lock:
            return self._cheap_s

    def _evict_locked(self, store: OrderedDict) -> None:
        while len(store) > self.max_fingerprints:
            store.popitem(last=False)

    # -- views ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"fingerprints": len(self._rates),
                    "service_tracked": len(self._service),
                    "cheap_s": self._cheap_s,
                    "horizon_s": self.horizon_s, "tau_s": self.tau_s}

    def snapshot(self) -> dict:
        """{fingerprint: {"rate", "hint", "hot"}} for the hot set —
        the trace-report / stats view."""
        with self._lock:
            fps = list(self._rates)
        out = {}
        for fp in fps:
            r = self.rate(fp)
            hint = max(1, min(self.max_hint, int(r * self.horizon_s)))
            out[fp] = {"rate": r, "hint": hint,
                       "hot": hint >= self.hot_hint}
        return out
