"""planner.digest_ms: the time of the program's ``digest`` spans
(``Planner._build_runner``: the executor cache's key, from the digests
of the operands' values and of the plan's layout) in the window, per
request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("digest"):
        return None
    return 1e3 * obs.span_s("digest") / obs.requests
