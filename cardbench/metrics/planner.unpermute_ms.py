"""planner.unpermute_ms: the time of the program's ``unpermute`` spans
(``Planner._unpermuted``: C's rows, or rows and columns, put back in
the original order) in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("unpermute"):
        return None
    return 1e3 * obs.span_s("unpermute") / obs.requests
