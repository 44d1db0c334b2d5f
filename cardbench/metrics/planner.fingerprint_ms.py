"""planner.fingerprint_ms: the time of the program's ``fingerprint``
spans (``Planner.plan``: the hash of A's pattern, before the ``plan``
span) in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("fingerprint"):
        return None
    return 1e3 * obs.span_s("fingerprint") / obs.requests
