"""planner.guard_ms: the time of the program's ``guard`` spans
(``Planner._guarded_execute``: the ``output`` fault site and the
float64 finiteness sum of C) in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("guard"):
        return None
    return 1e3 * obs.span_s("guard") / obs.requests
