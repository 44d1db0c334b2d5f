"""serve.unattributed_ms: the time of each ``request`` span
(``SpGEMMServer.submit``) that no other program span inside it covers,
summed over the window, per request served. The grouping spans
``execute`` and ``kernel`` do not cover: their own time, outside their
children, counts as unattributed. Overlapping spans count once."""

import bisect

from cardbench import profiling

GROUPING = ("request", "execute", "kernel")


def read(obs):
    if obs.requests <= 0 or not obs.has_span("request"):
        return None
    inner = sorted((s, e) for n, s, e in obs.spans if n not in GROUPING)
    starts = [s for s, _ in inner]
    longest = max((e - s for s, e in inner), default=0.0)
    total = 0.0
    for n, rs, re in obs.spans:
        if n != "request":
            continue
        # an inner span that overlaps the request starts before its end
        # and no earlier than the longest inner span before its start
        lo = bisect.bisect_left(starts, rs - longest)
        hi = bisect.bisect_left(starts, re)
        covered = profiling.merged((max(s, rs), min(e, re))
                                   for s, e in inner[lo:hi] if e > rs)
        total += (re - rs) - sum(e - s for s, e in covered)
    return 1e3 * total / obs.requests
