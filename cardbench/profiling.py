"""Reading a profiled stretch of the window: device activity on the host's
clock, the busy share, and idle gaps labelled by the program's spans.

Everything here works on plain tuples, so the readers can be tested on
synthetic events: a device event is ``(name, kind, start_s, end_s)``
with ``kind`` one of ``kernel``, ``memcpy``, ``memset``; a span is
``(name, start_s, end_s)``; both on the host's ``perf_counter`` clock.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

__all__ = ["Profile", "from_torch", "merged", "busy_s", "kernel_s",
           "idle_gaps", "top_ops", "gaps_by_span", "OUTSIDE"]

# the label of idle time during which no span of the program was open
OUTSIDE = "outside the program"


@dataclasses.dataclass
class Profile:
    """Device events of one profiled stretch ``[t0, t1]``."""

    t0: float
    t1: float
    events: list

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy") or "memcpy " in low:
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def from_torch(prof, mark: str, t_mark: float, t0: float,
               t1: float) -> Profile:
    """The device events of a ``torch.profiler`` run on the host's clock.

    ``mark`` is a ``record_function`` range opened at host time
    ``t_mark``: its start on the profiler's clock sets the offset between
    the two clocks."""
    from torch.autograd import DeviceType
    events = prof.events()
    starts = [ev.time_range.start for ev in events if ev.name == mark]
    if not starts:
        raise RuntimeError(f"profiler trace lacks the clock mark {mark!r}")
    off = t_mark - starts[0] * 1e-6
    out = []
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        s = ev.time_range.start * 1e-6 + off
        e = ev.time_range.end * 1e-6 + off
        if e <= t0 or s >= t1:
            continue
        out.append((ev.name, _kind(ev.name), max(s, t0), min(e, t1)))
    return Profile(t0, t1, out)


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(p: Profile) -> float:
    """Seconds of the stretch in which a kernel, copy or set ran."""
    return sum(e - s for s, e in merged((s, e) for _, _, s, e in p.events))


def kernel_s(p: Profile) -> float:
    """Device time of the compute kernels (copies and sets left out)."""
    return sum(e - s for _, k, s, e in p.events if k == "kernel")


def idle_gaps(p: Profile) -> list[tuple[float, float]]:
    """The stretch's intervals with nothing running on the device."""
    gaps, cur = [], p.t0
    for s, e in merged((s, e) for _, _, s, e in p.events):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if p.t1 > cur:
        gaps.append((cur, p.t1))
    return gaps


def top_ops(p: Profile, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time, by name."""
    by: dict[str, float] = defaultdict(float)
    for name, _, s, e in p.events:
        by[name] += e - s
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def gaps_by_span(p: Profile, spans, n: int = 10) -> list[list]:
    """Idle seconds summed by the innermost span open on the host at each
    gap's midpoint (``OUTSIDE`` where none was); the ``n`` largest."""
    by: dict[str, float] = defaultdict(float)
    ordered = sorted((sp for sp in spans if sp[2] >= p.t0 and sp[1] <= p.t1),
                     key=lambda sp: sp[1])
    starts = [sp[1] for sp in ordered]
    longest = max((e - s for _, s, e in ordered), default=0.0)
    for gs, ge in idle_gaps(p):
        mid = 0.5 * (gs + ge)
        label = OUTSIDE
        # the open span that started last is the innermost one
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            name, s, e = ordered[i]
            if s < mid - longest:
                break
            if e >= mid:
                label = name
                break
        by[label] += ge - gs
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
