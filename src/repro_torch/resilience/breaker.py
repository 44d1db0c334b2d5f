"""Circuit breaker over (fingerprint, scheme, variant) execution triples.

When a plan's runner fails, the degradation ladder recovers *that*
request — the breaker makes sure the *next* request does not walk into
the same failure: the failing triple is quarantined, and
``Planner.plan`` re-plans around it (the quarantined candidate is
filtered out of the menu; a cached plan on the triple is bypassed
without being evicted, so a healed triple serves again instantly).

States per triple::

    closed ──failures ≥ threshold──▶ open ──retry_after elapsed──▶ half-open
      ▲                                ▲                               │
      │                                └─────────── failure ───────────┤
      └──────────────────────────────── success ───────────────────────┘

* **closed** — untracked (no memory cost for healthy triples).
* **open** — :meth:`allows` is False: plans route around the triple.
* **half-open** — after ``retry_after`` seconds :meth:`allows` turns
  True again: the next request *trials* the triple. Success closes the
  breaker (transient failures heal); failure re-opens it with the
  timeout doubled (capped), so a persistently-broken variant backs off
  instead of flapping.

The clock is injectable (``clock=``) so the chaos suite drives the
half-open transition deterministically. Thread-safe: one lock around
the tiny state dict.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

__all__ = ["CircuitBreaker", "BreakerEntry"]


class BreakerEntry:
    """Mutable per-triple state (internal)."""

    __slots__ = ("failures", "opened_at", "retry_after", "state")

    def __init__(self):
        self.failures = 0
        self.opened_at = 0.0
        self.retry_after = 0.0
        self.state = "closed"


class CircuitBreaker:
    """Quarantine registry keyed by ``(fingerprint, scheme, variant)``.

    Args:
      failure_threshold: consecutive failures before a triple opens
        (default 1 — in serving, one deep kernel failure is expensive
        enough that the second request should already re-plan).
      retry_after_s: seconds an open triple waits before the half-open
        trial window.
      backoff: multiplier applied to ``retry_after`` on a failed trial.
      max_retry_after_s: backoff ceiling.
      clock: monotonic time source (injectable for tests).
    """

    def __init__(self, failure_threshold: int = 1,
                 retry_after_s: float = 30.0, *, backoff: float = 2.0,
                 max_retry_after_s: float = 600.0,
                 clock: Optional[Callable[[], float]] = None):
        self.failure_threshold = int(failure_threshold)
        self.retry_after_s = float(retry_after_s)
        self.backoff = float(backoff)
        self.max_retry_after_s = float(max_retry_after_s)
        self.clock = clock if clock is not None else time.monotonic
        self._state: dict[tuple, BreakerEntry] = {}
        self._lock = threading.Lock()
        self.opened = 0          # lifetime open transitions
        self.healed = 0          # lifetime half-open → closed heals

    # -- queries -------------------------------------------------------------

    def allows(self, key: tuple) -> bool:
        """Whether executions of ``key`` may proceed. Pure read except
        for the open → half-open transition when the retry window has
        elapsed. Closed (untracked) triples short-circuit on an empty
        registry — the steady-state cost is one ``if not dict``."""
        if not self._state:
            return True
        with self._lock:
            e = self._state.get(key)
            if e is None or e.state == "half-open":
                return True
            if e.state == "closed":
                return True
            if self.clock() - e.opened_at >= e.retry_after:
                e.state = "half-open"
                return True
            return False

    def state(self, key: tuple) -> str:
        with self._lock:
            e = self._state.get(key)
            if e is None:
                return "closed"
            # surface the elapsed-retry window as half-open even before
            # an allows() call performs the transition
            if e.state == "open" \
                    and self.clock() - e.opened_at >= e.retry_after:
                return "half-open"
            return e.state

    def open_keys(self) -> list[tuple]:
        """Currently quarantined triples (open or half-open) — the
        ``quarantine`` gauge's value."""
        with self._lock:
            return [k for k, e in self._state.items()
                    if e.state in ("open", "half-open")]

    # -- outcomes ------------------------------------------------------------

    def record_failure(self, key: tuple) -> str:
        """Account one execution failure of ``key``; returns the new
        state. A failed half-open trial re-opens with backoff."""
        with self._lock:
            e = self._state.setdefault(key, BreakerEntry())
            e.failures += 1
            if e.state == "half-open":
                e.retry_after = min(e.retry_after * self.backoff,
                                    self.max_retry_after_s)
                e.state = "open"
                e.opened_at = self.clock()
            elif e.state == "closed" \
                    and e.failures >= self.failure_threshold:
                e.state = "open"
                e.opened_at = self.clock()
                e.retry_after = self.retry_after_s
                self.opened += 1
            return e.state

    def record_success(self, key: tuple) -> None:
        """Account one successful execution: a tracked triple (a
        half-open trial, or a closed one accumulating sub-threshold
        failures) resets to untracked. No-op (one dict miss) for
        healthy triples."""
        if not self._state:
            return
        with self._lock:
            e = self._state.pop(key, None)
            if e is not None and e.state in ("open", "half-open"):
                self.healed += 1

    def reset(self) -> None:
        with self._lock:
            self._state.clear()

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"tracked": len(self._state),
                    "open": sum(1 for e in self._state.values()
                                if e.state == "open"),
                    "half_open": sum(1 for e in self._state.values()
                                     if e.state == "half-open"),
                    "opened_total": self.opened,
                    "healed_total": self.healed}
