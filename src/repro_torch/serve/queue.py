"""Bounded request queue with per-tenant admission control.

The front-end's first line of defense against overload: a fixed-capacity
FIFO whose :meth:`BoundedRequestQueue.offer` *rejects* — with a
structured :class:`~repro_torch.resilience.errors.OverloadError` — instead of
growing when requests arrive faster than plans execute. Per-tenant depth
limits keep one flooding tenant from consuming the whole queue: a tenant
at its partition cap is shed with ``reason="tenant_depth"`` even while
global capacity remains for the others.

:class:`Ticket` is the minimal future the front-end hands back on
admission: the worker (or an inline :meth:`pump
<repro_torch.serve.frontend.AsyncSpGEMMServer.pump>` call) resolves it with
either the :class:`~repro_torch.serve.engine.SpGEMMResponse` or a structured
error; ``result()`` blocks (with optional timeout) and re-raises. A
request that failed *admission* never gets a ticket — ``submit`` raises
synchronously, so the caller's backpressure signal is immediate.

Everything is condition-variable-based and thread-safe; with no worker
threads the queue degenerates to a deterministic FIFO the tests and the
burst benchmark drain explicitly.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Optional

from repro_torch.resilience.errors import OverloadError

__all__ = ["BoundedRequestQueue", "QueuedRequest", "Ticket"]


class Ticket:
    """One request's completion latch (a minimal, dependency-free future)."""

    __slots__ = ("_event", "_response", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._response = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def resolve(self, response) -> None:
        self._response = response
        self._event.set()

    def reject(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def error(self) -> Optional[BaseException]:
        """The structured error (None while pending or on success)."""
        return self._error

    def result(self, timeout: Optional[float] = None):
        """Block until resolved; returns the response or re-raises the
        structured error the worker recorded."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._response


@dataclasses.dataclass
class QueuedRequest:
    """One admitted request, as the worker sees it."""

    a: object                          # HostCSR
    b: object = None                   # HostCSR | np.ndarray | None
    hops: Optional[int] = None
    tenant: str = ""
    fingerprint: str = ""
    ticket: Ticket = dataclasses.field(default_factory=Ticket)
    coalesce_key: str = ""             # "" = not coalescable
    reuse_hint: Optional[int] = None   # explicit caller override
    deadline_at: Optional[float] = None   # absolute clock() time
    deadline_s: float = 0.0            # the original relative budget
    enqueued_at: float = 0.0
    downgrade: bool = False            # admission chose the identity rung


class BoundedRequestQueue:
    """Fixed-capacity FIFO with per-tenant depth partitions.

    Args:
      capacity: global depth bound — ``offer`` past it sheds.
      tenant_capacity: per-tenant depth bound (defaults to ``capacity``,
        i.e. no per-tenant partitioning). The empty tenant ``""`` is a
        tenant like any other.
    """

    def __init__(self, capacity: int = 64,
                 tenant_capacity: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.tenant_capacity = (int(tenant_capacity)
                                if tenant_capacity is not None
                                else self.capacity)
        if self.tenant_capacity < 1:
            raise ValueError("tenant_capacity must be >= 1")
        self._items: deque[QueuedRequest] = deque()
        self._by_tenant: dict[str, int] = {}
        self._cv = threading.Condition()

    # -- producer ------------------------------------------------------------

    def offer(self, req: QueuedRequest) -> int:
        """Admit ``req`` or raise :class:`OverloadError`; returns the
        post-admission depth. Never blocks — a full queue is a shed, not
        a wait (the caller is the backpressure boundary)."""
        with self._cv:
            depth = len(self._items)
            if depth >= self.capacity:
                raise OverloadError("capacity", tenant=req.tenant,
                                    depth=depth, limit=self.capacity)
            t_depth = self._by_tenant.get(req.tenant, 0)
            if t_depth >= self.tenant_capacity:
                raise OverloadError("tenant_depth", tenant=req.tenant,
                                    depth=t_depth,
                                    limit=self.tenant_capacity)
            self._items.append(req)
            self._by_tenant[req.tenant] = t_depth + 1
            self._cv.notify()
            return depth + 1

    # -- consumer ------------------------------------------------------------

    def take(self, timeout: Optional[float] = None
             ) -> Optional[QueuedRequest]:
        """Pop the oldest request, blocking up to ``timeout`` seconds
        (``timeout=0`` polls). Returns ``None`` on an empty queue."""
        with self._cv:
            if not self._items and timeout:
                self._cv.wait(timeout)
            if not self._items:
                return None
            req = self._items.popleft()
            self._dec_tenant(req.tenant)
            return req

    def take_group(self, *, limit: int = 1, predicate=None,
                   now: Optional[float] = None
                   ) -> tuple[list[QueuedRequest], list[QueuedRequest]]:
        """Pop the head plus up to ``limit - 1`` later requests for which
        ``predicate(head, req)`` holds, preserving FIFO order; requests
        the predicate rejects stay queued in place. Returns
        ``(group, expired)``.

        Unlike :meth:`take` (one item, expiry checked by the worker at
        dequeue), this is the batching dequeue — and the expiry check
        moves *into the drain*: with ``now`` given, every queued request
        whose ``deadline_at`` has passed is swept out first and returned
        in ``expired``, so a dead-budget ticket can never be packed into
        a batch (it would waste batched kernel work on a result the
        caller already abandoned, and its slot in the group is better
        spent on a live request). Per-tenant depth accounting is updated
        per popped item — group members and swept-expired alike — exactly
        as :meth:`take` would have.
        """
        with self._cv:
            expired: list[QueuedRequest] = []
            if now is not None:
                live: deque[QueuedRequest] = deque()
                for req in self._items:
                    if req.deadline_at is not None and now >= req.deadline_at:
                        expired.append(req)
                        self._dec_tenant(req.tenant)
                    else:
                        live.append(req)
                self._items = live
            group: list[QueuedRequest] = []
            if self._items:
                head = self._items.popleft()
                self._dec_tenant(head.tenant)
                group.append(head)
                if limit > 1 and predicate is not None:
                    keep: deque[QueuedRequest] = deque()
                    for req in self._items:
                        if len(group) < limit and predicate(head, req):
                            group.append(req)
                            self._dec_tenant(req.tenant)
                        else:
                            keep.append(req)
                    self._items = keep
            return group, expired

    def wait_for_item(self, timeout: float) -> bool:
        """Block up to ``timeout`` seconds for a non-empty queue (worker
        threads park here between :meth:`take_group` polls)."""
        with self._cv:
            if not self._items:
                self._cv.wait(timeout)
            return bool(self._items)

    def _dec_tenant(self, tenant: str) -> None:
        """Decrement one tenant's depth (callers hold ``_cv``)."""
        left = self._by_tenant.get(tenant, 1) - 1
        if left > 0:
            self._by_tenant[tenant] = left
        else:
            self._by_tenant.pop(tenant, None)

    def drain(self) -> list[QueuedRequest]:
        """Pop everything (shutdown path)."""
        with self._cv:
            out = list(self._items)
            self._items.clear()
            self._by_tenant.clear()
            return out

    # -- views ---------------------------------------------------------------

    def depth(self) -> int:
        with self._cv:
            return len(self._items)

    def depth_of(self, tenant: str) -> int:
        with self._cv:
            return self._by_tenant.get(tenant, 0)

    def fill_frac(self) -> float:
        """Queue fullness in [0, 1] — what the degradation watermarks
        compare against."""
        with self._cv:
            return len(self._items) / self.capacity

    def stats(self) -> dict:
        with self._cv:
            return {"depth": len(self._items), "capacity": self.capacity,
                    "tenant_capacity": self.tenant_capacity,
                    "by_tenant": dict(self._by_tenant)}
