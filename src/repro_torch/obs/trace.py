"""Context-manager tracing spans for the serving request path.

Design goals, in priority order:

1. **The disabled tracer is a strict no-op.** ``Tracer.span`` returns a
   process-wide singleton whose ``__enter__``/``__exit__`` do nothing —
   no :class:`Span` objects are constructed, nothing touches the ring
   buffer, no clock is read. Call sites that would compute *expensive*
   attributes (device counters, digests) must additionally guard on
   ``tracer.enabled`` so the attribute computation itself is skipped.
2. **Nesting and attribute propagation.** Spans form a per-thread stack;
   a child inherits its parent's ``trace_id`` and records the parent's
   ``span_id``, so one serving request (the root ``request`` span) owns
   every nested ``plan``/``pack``/``execute``/``kernel`` span it caused.
3. **Bounded memory.** Finished spans land in a ring buffer
   (``capacity`` spans, oldest dropped first; drops are counted), so a
   long-running server with tracing left on cannot grow without bound.
4. **The profiler's clock.** While a ``torch.profiler`` run records, a
   live span also opens a profiler range of its own name, so the
   profiler's trace shows the program's spans beside the kernels with
   no clock offset to compute. The range is a function-scope record
   (``_RecordFunctionFast``), not a user annotation: a user annotation
   is mirrored onto the device's timeline as an event of its own, which
   a reader of device activity would count as busy time.

Exporter: :meth:`Tracer.export_chrome` (Chrome trace-event format: load
the file in ``chrome://tracing`` or https://ui.perfetto.dev to see the
nested timeline).

Timing is ``time.perf_counter()`` (monotonic); timestamps in the export
are microseconds relative to the tracer's epoch.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

import torch

__all__ = ["Span", "Tracer", "get_tracer", "span", "NOOP_SPAN"]


@dataclasses.dataclass(slots=True)
class Span:
    """One finished timed region (immutable once recorded)."""

    name: str
    trace_id: str
    span_id: int
    parent_id: int          # 0 = root
    t0: float               # seconds since tracer epoch (monotonic)
    duration: float         # seconds
    attrs: dict
    thread_id: int = 0


class _NoopSpan:
    """The disabled tracer's span: a shared do-nothing context manager.

    Carries the same surface as :class:`_LiveSpan` (``set``,
    ``trace_id``) so instrumented code never branches on tracer state.
    """

    __slots__ = ()
    trace_id = ""
    span_id = 0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    """An open span: created by :meth:`Tracer.span` when enabled.

    The enter/exit path is the serving hot path when tracing is on —
    it records a plain tuple into the ring buffer (:class:`Span`
    objects are materialized lazily by :meth:`Tracer.spans`) and caches
    the thread's stack list so exit does not re-resolve thread locals.
    """

    __slots__ = ("_tracer", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "_t0", "_stack_ref", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.trace_id = ""
        self.span_id = 0
        self.parent_id = 0
        self._t0 = 0.0
        self._range = None

    def set(self, **attrs) -> "_LiveSpan":
        """Attach/overwrite attributes on the open span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        tr = self._tracer
        stack = tr._stack()
        self._stack_ref = stack
        if stack:
            parent = stack[-1]
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = tr._new_trace_id()
        self.span_id = next(tr._ids)
        stack.append(self)
        self._range = _profiler_range(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        stack = self._stack_ref
        # tolerate exceptions unwinding multiple frames at once
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        tr = self._tracer
        tr._record((self.name, self.trace_id, self.span_id,
                    self.parent_id, self._t0 - tr._epoch, t1 - self._t0,
                    self.attrs, threading.get_ident() & 0x7FFFFFFF))
        return False


def _profiler_range(name: str):
    """An open ``torch.profiler`` range named ``name`` while a profiler
    records, else ``None`` (one flag read)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


class Tracer:
    """Process-global span collector with a bounded ring buffer.

    Starts disabled: :meth:`span` returns :data:`NOOP_SPAN` and records
    nothing until :meth:`enable` is called.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = False):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.dropped = 0
        # ring of raw span tuples (Span field order) — see spans()
        self._buf: deque[tuple] = deque(maxlen=self.capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._traces = itertools.count(1)
        self._epoch = time.perf_counter()

    # -- span creation -------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a timed region: ``with tracer.span("plan", fp=...) as s:``.

        Disabled mode returns the shared no-op singleton — zero span
        allocations, zero buffer writes, zero clock reads.
        """
        if not self.enabled:
            return NOOP_SPAN
        return _LiveSpan(self, name, attrs)

    # -- state ---------------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> "Tracer":
        if capacity is not None and capacity != self.capacity:
            self.capacity = int(capacity)
            self._buf = deque(self._buf, maxlen=self.capacity)
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def spans(self) -> list[Span]:
        """Snapshot of the ring buffer, oldest first.

        The hot path records bare tuples; :class:`Span` objects are
        materialized here, off the serving path.
        """
        return [Span(*rec) for rec in self._buf]

    # -- internals -----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _new_trace_id(self) -> str:
        return f"t{os.getpid():x}-{next(self._traces):06x}"

    def _record(self, rec: tuple) -> None:
        """Append one raw span tuple (Span field order) to the ring."""
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._buf.append(rec)

    # -- exporter ------------------------------------------------------------

    def export_chrome(self, path: str) -> int:
        """Write Chrome trace-event JSON (Perfetto/chrome://tracing).

        Each span becomes one complete ("ph": "X") event; requests show
        as separate tracks because the root span's trace ordinal is used
        as the tid, so concurrent requests do not overpaint each other.
        """
        spans = self.spans()
        tids = {}
        for sp in spans:
            tids.setdefault(sp.trace_id, len(tids) + 1)
        events = [{
            "name": sp.name, "ph": "X", "pid": os.getpid(),
            "tid": tids[sp.trace_id],
            "ts": round(sp.t0 * 1e6, 3),
            "dur": round(sp.duration * 1e6, 3),
            "args": {**sp.attrs, "trace_id": sp.trace_id,
                     "span_id": sp.span_id, "parent_id": sp.parent_id},
        } for sp in spans]
        meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(),
                 "tid": tid, "args": {"name": f"request {trace}"}}
                for trace, tid in tids.items()]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer every instrumented module shares."""
    return _TRACER


def span(name: str, **attrs):
    """Module-level convenience for ``get_tracer().span(...)``."""
    return _TRACER.span(name, **attrs)
