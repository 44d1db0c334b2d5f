"""Overload-robust async serving front-end for the SpGEMM planner stack.

``SpGEMMServer`` (``serve/engine.py``) is a per-call library: one
synchronous ``submit`` at a time, a *static* ``reuse_hint``. This module
turns it into a server that survives real multi-tenant traffic:

1. **Bounded queue + admission control** — requests enter through a
   fixed-capacity FIFO with per-tenant depth partitions
   (``serve/queue.py``); a full queue sheds with a structured
   :class:`~repro_torch.resilience.errors.OverloadError` (``serve_shed``
   metric) instead of growing unboundedly.
2. **Deadlines with backpressure** — a request whose remaining budget
   cannot cover the predicted plan+execute cost is shed at admission
   (:class:`~repro_torch.resilience.errors.DeadlineExceededError`,
   ``serve_deadline_miss``) or *downgraded* to the identity rung when
   that still fits; a budget that expires while queued sheds at
   dequeue; a completion that overruns is counted and flagged, never
   raised mid-flight.
3. **Coalescing** — concurrent requests with identical operands (same
   fingerprint *and* values) dedupe onto one in-flight execution via a
   single-flight latch; waiters share the result bit-identically. Same
   fingerprint with different values shares the plan and the packed
   operand through the planner's caches (plus the planner's own
   single-flight plan lock) without sharing results.
4. **Load-adaptive degradation** — queue-depth watermarks
   (:class:`~repro_torch.resilience.policy.Watermarks`) reuse the
   degradation ladder *proactively*: under pressure, fingerprints the
   live estimator has not graded hot are admitted on the ladder's
   identity floor (zero preprocessing — the paper's break-even rule with
   reuse forced to 1) and graduate to full plans once pressure clears.
5. **Live reuse estimation** — per-fingerprint EWMA arrival rates
   (``serve/estimator.py``) replace the static ``default_reuse_hint``:
   the estimator is injected into ``Planner.plan`` as its
   ``hint_provider``, so the break-even rule sees measured recurrence.
   A scheduled ``fit_calibration(samples=auditor.samples())`` refresh
   closes the drift auditor's loop from live traffic.
6. **Cross-request batching** — the pump drains a *compatible group* of
   queued sub-threshold requests (``serve/batcher.py``) and serves them
   with one block-diagonal launch, splitting the product back per
   ticket bit-identically; distinct small requests stop paying N×
   dispatch. Batching stands down under watermark pressure — a packed
   group's pattern is by construction cold, and planning cold patterns
   is exactly the work pressure sheds — and a faulted batch disbands
   into individually ladder-guarded singles.

Threading: ``workers >= 1`` starts background worker threads, which
share the inner server's planner (its plan cache, exec cache and drift
auditor are guarded for that); ``workers=0`` is the deterministic mode —
``submit`` only enqueues and the caller drains with
:meth:`AsyncSpGEMMServer.pump` (what the tests use). The clock is
injectable everywhere.

Without an inner server the front-end builds ``SpGEMMServer()``, which
runs on the card and raises without one; pass a server built with
``device="cpu"`` to serve on the CPU.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.obs import metrics as obs_metrics
from repro_torch.planner.features import fingerprint
from repro_torch.planner.service import _value_digest
from repro_torch.resilience.errors import (DeadlineExceededError,
                                           OverloadError)
from repro_torch.serve.batcher import (BatchPolicy, Batcher, batchable,
                                       compatible)
from repro_torch.serve.engine import SpGEMMResponse, SpGEMMServer
from repro_torch.serve.estimator import ReuseEstimator
from repro_torch.serve.queue import (BoundedRequestQueue, QueuedRequest,
                                     Ticket)

__all__ = ["AsyncSpGEMMServer"]


class AsyncSpGEMMServer:
    """Admission-controlled, deadline-aware, coalescing front-end.

    Args:
      server: the inner :class:`SpGEMMServer` (default-constructed on the
        card when omitted). Its planner gains the estimator as
        ``hint_provider``.
      capacity: bounded-queue depth (global).
      tenant_capacity: per-tenant depth partition (default: capacity).
      workers: background worker threads; ``0`` = deterministic inline
        mode (callers drain via :meth:`pump`).
      estimator: the :class:`ReuseEstimator` (default-constructed with
        the same ``clock``).
      clock: monotonic time source, injected into queue-wait and
        deadline arithmetic (tests drive it).
      recalibrate_every: completed-request period of the scheduled
        ``fit_calibration(samples=auditor.samples())`` refresh
        (``None`` disables).
      batch_policy: what the pump may pack into one block-diagonal
        launch (:class:`~repro_torch.serve.batcher.BatchPolicy`; default
        enabled — pass ``BatchPolicy(enabled=False)`` for strictly
        one-launch-per-request serving).
    """

    def __init__(self, server: Optional[SpGEMMServer] = None, *,
                 capacity: int = 64,
                 tenant_capacity: Optional[int] = None,
                 workers: int = 1,
                 estimator: Optional[ReuseEstimator] = None,
                 clock: Optional[Callable[[], float]] = None,
                 recalibrate_every: Optional[int] = None,
                 batch_policy: Optional[BatchPolicy] = None):
        self.server = server if server is not None else SpGEMMServer()
        self.clock = clock if clock is not None else time.monotonic
        self.estimator = (estimator if estimator is not None
                          else ReuseEstimator(clock=self.clock))
        # hint injection: the planner's break-even rule now sees the
        # measured per-fingerprint arrival rate instead of the server's
        # static default_reuse_hint
        self.server.planner.hint_provider = self.estimator.reuse_hint
        self.queue = BoundedRequestQueue(capacity,
                                         tenant_capacity=tenant_capacity)
        self.recalibrate_every = recalibrate_every
        self.batch_policy = (batch_policy if batch_policy is not None
                             else BatchPolicy())
        self.batcher = Batcher(self.server.planner, clock=self.clock)
        self._mu = threading.Lock()
        self._inflight: dict[str, list[Ticket]] = {}
        self._planned: set[str] = set()     # fps served a full plan
        self._pressure = False              # watermark hysteresis state
        self._completions = 0
        # launch-amortization accounting: completed queued requests per
        # planner-routed launch (1.0 unbatched; batching raises it)
        self._launches = 0
        self._served = 0
        self._batches = 0
        self._batched_members = 0
        self._closed = False
        # fingerprint memo keyed by operand object identity (the same
        # immutability contract as policy validation memoization)
        self._fp_alive: weakref.WeakValueDictionary = \
            weakref.WeakValueDictionary()
        self._fp_memo: dict[int, str] = {}
        self._threads: list[threading.Thread] = []
        for i in range(int(workers)):
            t = threading.Thread(target=self._worker,
                                 name=f"spgemm-serve-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    # -- admission -----------------------------------------------------------

    def submit(self, a: HostCSR, b=None, *, tenant: str = "",
               hops: Optional[int] = None,
               reuse_hint: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit (or shed) one request; returns its :class:`Ticket`.

        Sheds raise synchronously — :class:`OverloadError` when the
        queue (or the tenant's partition) is full,
        :class:`DeadlineExceededError` when the predicted plan+execute
        cost already exceeds ``deadline_s`` and not even the downgraded
        identity path fits. An admitted request resolves its ticket with
        the :class:`SpGEMMResponse` (or the structured error that ended
        it) once a worker — or a :meth:`pump` call — executes it.
        """
        if self._closed:
            raise OverloadError("shutdown", tenant=tenant)
        fp = self._fingerprint(a)
        self.estimator.observe(fp)     # arrivals count even when shed
        now = self.clock()
        req = QueuedRequest(a=a, b=b, hops=hops, tenant=tenant,
                            fingerprint=fp, reuse_hint=reuse_hint,
                            deadline_s=deadline_s or 0.0,
                            enqueued_at=now,
                            coalesce_key=self._coalesce_key(fp, a, b, hops))
        if deadline_s is not None:
            req.deadline_at = now + float(deadline_s)
            self._admission_deadline(req, fp, float(deadline_s), tenant)
        reg = obs_metrics.get_registry()
        with self._mu:
            waiters = self._inflight.get(req.coalesce_key)
            if waiters is not None:
                # identical request already in flight: ride its latch
                waiters.append(req.ticket)
                reg.counter("serve_coalesced", tenant=tenant).inc()
                return req.ticket
            try:
                depth = self.queue.offer(req)
            except OverloadError as e:
                self._note_shed(e.reason, tenant)
                raise
            if req.coalesce_key:
                self._inflight[req.coalesce_key] = []
            self._update_pressure(depth)
        reg.gauge("serve_queue_depth").set(depth)
        return req.ticket

    def submit_wait(self, a: HostCSR, b=None, *,
                    timeout: Optional[float] = None,
                    **kwargs) -> SpGEMMResponse:
        """``submit`` + block for the result — the drop-in synchronous
        surface. In inline mode (``workers=0``) the caller's own thread
        drains the queue first."""
        ticket = self.submit(a, b, **kwargs)
        if not self._threads:
            self.pump()
        return ticket.result(timeout)

    def _admission_deadline(self, req: QueuedRequest, fp: str,
                            budget_s: float, tenant: str) -> None:
        """Shed-or-downgrade when the predicted cost exceeds the budget.
        Unknown costs (no completed sample yet) always admit."""
        pred = self.estimator.predicted_service_s(fp)
        if pred is None or pred <= budget_s:
            return
        cheap = self.estimator.predicted_cheap_s()
        if cheap is not None and cheap <= budget_s:
            req.downgrade = True       # fits on the identity rung
            return
        reg = obs_metrics.get_registry()
        reg.counter("serve_deadline_miss", stage="admission",
                    tenant=tenant).inc()
        self._note_shed("deadline", tenant)
        raise DeadlineExceededError("admission", deadline_s=budget_s,
                                    predicted_s=pred)

    def _note_shed(self, reason: str, tenant: str) -> None:
        obs_metrics.get_registry().counter("serve_shed", reason=reason,
                                           tenant=tenant).inc()
        self.server.planner.resilience.sheds += 1

    # -- execution -----------------------------------------------------------

    def pump(self, max_items: Optional[int] = None) -> int:
        """Drain queued requests on the caller's thread (deterministic
        mode); returns how many were retired. One round retires a whole
        dequeued group (batch members + swept-expired tickets), so the
        return can exceed ``max_items`` by the final group's size."""
        done = 0
        while max_items is None or done < max_items:
            n = self._pump_once()
            if n == 0:
                break
            done += n
        return done

    def _worker(self) -> None:
        while not self._closed:
            if self._pump_once() == 0:
                self.queue.wait_for_item(0.05)

    def _pump_once(self) -> int:
        """One dequeue round: sweep deadline-expired tickets, pop the
        head — plus a compatible sub-threshold group when batching
        applies — and serve it. Returns requests retired (0 = empty).

        Batching stands down under watermark pressure: a packed group's
        pattern is by construction a cold fingerprint, and planning cold
        patterns is exactly the work the pressure downgrade sheds — the
        singles path keeps its guaranteed-cheap identity floor.
        """
        pol = self.batch_policy
        with self._mu:
            batching = pol.enabled and not self._pressure
        rows = [0]

        def _pred(head: QueuedRequest, req: QueuedRequest) -> bool:
            if not (batchable(head, pol) and batchable(req, pol)
                    and compatible(head, req)):
                return False
            if rows[0] == 0:
                rows[0] = head.a.nrows
            if rows[0] + req.a.nrows > pol.max_total_rows:
                return False
            rows[0] += req.a.nrows
            return True

        group, expired = self.queue.take_group(
            limit=pol.max_members if batching else 1,
            predicate=_pred if batching else None,
            now=self.clock())
        for req in expired:
            self._expire(req)
        if not group:
            return len(expired)
        if len(group) >= pol.min_members:
            self._process_batch(group)
        else:
            self._process(group[0])
        return len(group) + len(expired)

    def _expire(self, req: QueuedRequest) -> None:
        """A ticket whose budget died while queued — swept at dequeue by
        ``take_group`` so it can never be packed into a batch; counted
        exactly as the in-process queue-deadline check."""
        reg = obs_metrics.get_registry()
        now = self.clock()
        reg.gauge("serve_queue_depth").set(self.queue.depth())
        reg.histogram("serve_queue_wait_s",
                      tenant=req.tenant).observe(now - req.enqueued_at)
        reg.counter("serve_deadline_miss", stage="queue",
                    tenant=req.tenant).inc()
        self._resolve_error(req, DeadlineExceededError(
            "queue", deadline_s=req.deadline_s,
            waited_s=now - req.enqueued_at))

    def _process(self, req: QueuedRequest, *, dequeued: bool = False) -> None:
        """Execute one dequeued request; every outcome — response,
        structured shed, inner-stack failure — lands on the ticket (and
        its coalesced waiters). Nothing escapes the worker.

        ``dequeued=True`` marks a request whose dequeue bookkeeping
        (queue-wait histogram, depth gauge, queue-deadline check) already
        ran — the disband path re-runs batch members here without double
        counting; their lateness is a *completion* overrun, not a queue
        expiry, because execution had already begun."""
        reg = obs_metrics.get_registry()
        if not dequeued:
            now = self.clock()
            reg.gauge("serve_queue_depth").set(self.queue.depth())
            reg.histogram("serve_queue_wait_s",
                          tenant=req.tenant).observe(now - req.enqueued_at)
            if req.deadline_at is not None and now >= req.deadline_at:
                # the budget died in the queue: count + shed, never execute
                reg.counter("serve_deadline_miss", stage="queue",
                            tenant=req.tenant).inc()
                self._resolve_error(req, DeadlineExceededError(
                    "queue", deadline_s=req.deadline_s,
                    waited_s=now - req.enqueued_at))
                return
        downgrade = req.downgrade or self._should_downgrade(req.fingerprint)
        hint = 1 if downgrade else req.reuse_hint
        if downgrade:
            reg.counter("serve_downgrades", tenant=req.tenant).inc()
            self.server.planner.resilience.downgrades += 1
        try:
            resp = self.server.submit(req.a, req.b, reuse_hint=hint,
                                      hops=req.hops)
        except Exception as e:        # noqa: BLE001 — ticket carries it
            self._resolve_error(req, e)
            return
        self._note_launch(1)
        self._finish(req, resp, downgrade=downgrade)

    def _process_batch(self, group: list[QueuedRequest]) -> None:
        """Serve a compatible dequeued group with one block-diagonal
        launch; members the batcher hands back (validation reject,
        break-even decline, disbanded faulted batch) fall through to the
        individually ladder-guarded singles path."""
        reg = obs_metrics.get_registry()
        now = self.clock()
        reg.gauge("serve_queue_depth").set(self.queue.depth())
        for req in group:
            reg.histogram("serve_queue_wait_s",
                          tenant=req.tenant).observe(now - req.enqueued_at)
        outcomes = self.batcher.execute(group)
        n_batched = sum(1 for _, o in outcomes
                        if isinstance(o, SpGEMMResponse))
        if n_batched:
            self._note_launch(n_batched, batch=True)
        for req, outcome in outcomes:
            if outcome is None:
                self._process(req, dequeued=True)
            elif isinstance(outcome, SpGEMMResponse):
                self._finish(req, outcome, downgrade=False)
            else:
                self._resolve_error(req, outcome)

    def _finish(self, req: QueuedRequest, resp: SpGEMMResponse, *,
                downgrade: bool) -> None:
        """Post-execution bookkeeping shared by the single and batched
        paths: completion-deadline flag, estimator feedback, coalesced
        waiters, pressure update, recalibration schedule."""
        reg = obs_metrics.get_registry()
        resp.downgraded = downgrade
        if req.deadline_at is not None and self.clock() > req.deadline_at:
            # completed late: counted and flagged, not raised
            reg.counter("serve_deadline_miss", stage="completion",
                        tenant=req.tenant).inc()
            resp.deadline_missed = True
        self.estimator.note_service(req.fingerprint,
                                    resp.plan_s + resp.execute_s,
                                    downgraded=downgrade)
        with self._mu:
            if not downgrade:
                self._planned.add(req.fingerprint)
            waiters = self._inflight.pop(req.coalesce_key, None) or []
            self._update_pressure(self.queue.depth())
        req.ticket.resolve(resp)
        for t in waiters:
            t.resolve(dataclasses.replace(resp, coalesced=True))
        with self._mu:
            self._completions += 1
            due = bool(self.recalibrate_every
                       and self._completions % self.recalibrate_every == 0)
        if due:
            self.recalibrate()

    def _note_launch(self, served: int, *, batch: bool = False) -> None:
        """Account one planner-routed launch that completed ``served``
        queued requests, and publish the running amortization ratio
        (coalesced waiters ride for free and are deliberately excluded —
        they never held a queue slot or a launch)."""
        with self._mu:
            self._launches += 1
            self._served += served
            if batch:
                self._batches += 1
                self._batched_members += served
            amort = self._served / self._launches
        obs_metrics.get_registry().gauge(
            "batch_launch_amortization").set(amort)

    def _resolve_error(self, req: QueuedRequest, e: BaseException) -> None:
        with self._mu:
            waiters = self._inflight.pop(req.coalesce_key, None) or []
        req.ticket.reject(e)
        for t in waiters:
            t.reject(e)

    # -- load-adaptive degradation -------------------------------------------

    def _update_pressure(self, depth: int) -> None:
        """Watermark hysteresis (callers hold ``_mu``)."""
        frac = depth / self.queue.capacity
        wm = self.server.planner.resilience.watermarks
        if self._pressure:
            if frac <= wm.low:
                self._pressure = False
        elif frac >= wm.high:
            self._pressure = True

    def _should_downgrade(self, fp: str) -> bool:
        """Under watermark pressure, a fingerprint that is neither hot
        (estimator) nor already fully planned here takes the identity
        rung — preprocessing is exactly the work an overloaded queue
        cannot afford; it graduates when pressure clears (or its rate
        crosses the hot threshold, since a hot pattern amortizes even
        under load)."""
        with self._mu:
            if not self._pressure:
                return False
            if fp in self._planned:
                return False
        return not self.estimator.is_hot(fp)

    @property
    def pressure(self) -> bool:
        """Whether the watermark downgrade is currently active."""
        with self._mu:
            return self._pressure

    # -- coalescing / fingerprint helpers ------------------------------------

    def _fingerprint(self, a: HostCSR) -> str:
        """Pattern fingerprint memoized per live operand object (same
        id-with-weak-value discipline as validation memoization)."""
        oid = id(a)
        if self._fp_alive.get(oid) is a:
            return self._fp_memo[oid]
        fp = fingerprint(a)
        try:
            self._fp_alive[oid] = a
            self._fp_memo[oid] = fp
            if len(self._fp_memo) > 4096:     # drop dead ids
                alive = set(self._fp_alive.keys())
                self._fp_memo = {k: v for k, v in self._fp_memo.items()
                                 if k in alive}
        except TypeError:
            pass
        return fp

    def _coalesce_key(self, fp: str, a, b, hops) -> str:
        """Identity key for single-flight result sharing: pattern AND
        values of every operand (plus the workload shape). Requests that
        differ only in values share plan/pack through the planner's
        caches instead."""
        try:
            if b is None:
                bpart = f"sq|h{hops if hops is not None else 0}"
            elif isinstance(b, HostCSR):
                bpart = f"csr|{fingerprint(b)}|{_value_digest(b)}"
            else:
                import hashlib
                d = hashlib.blake2b(digest_size=8)
                d.update(np.ascontiguousarray(
                    np.asarray(b, dtype=np.float32)).tobytes())
                bpart = f"dense|{d.hexdigest()}"
        except Exception:                     # un-digestable operand:
            return ""                         # never coalesce, still serve
        return f"{fp}|{_value_digest(a)}|{bpart}"

    # -- calibration refresh -------------------------------------------------

    def recalibrate(self) -> bool:
        """Refit the cost model from the drift auditor's live samples
        (``fit_calibration(samples=auditor.samples())``) and install the
        result; returns whether a fit was applied. Scheduled every
        ``recalibrate_every`` completions, callable any time."""
        from repro_torch.planner.calibration import fit_calibration
        cal = fit_calibration(samples=self.server.planner.auditor.samples())
        obs_metrics.get_registry().counter(
            "serve_recalibrations",
            outcome="applied" if cal is not None else "skipped").inc()
        if cal is None:
            return False
        self.server.planner.cost_model.calibration = cal
        return True

    # -- lifecycle / views ---------------------------------------------------

    def close(self, *, drain: bool = True) -> None:
        """Stop workers; queued-but-unprocessed requests reject with
        ``OverloadError("shutdown")`` (after an optional final drain)."""
        if drain and not self._threads:
            self.pump()
        self._closed = True
        for t in self._threads:
            t.join(timeout=2.0)
        for req in self.queue.drain():
            self._resolve_error(req, OverloadError("shutdown",
                                                   tenant=req.tenant))

    def stats(self) -> dict:
        """Front-end snapshot layered over the inner server's."""
        with self._mu:
            inflight = len(self._inflight)
            planned = len(self._planned)
            pressure = self._pressure
            batching = {"batches": self._batches,
                        "batched_members": self._batched_members,
                        "launches": self._launches,
                        "served": self._served,
                        "launch_amortization": (
                            self._served / self._launches
                            if self._launches else 0.0)}
        return {"queue": self.queue.stats(),
                "pressure": pressure,
                "inflight_keys": inflight,
                "planned_fingerprints": planned,
                "completions": self._completions,
                "batching": batching,
                "estimator": self.estimator.stats(),
                "server": self.server.stats()}
