"""planner.copy_ms: the time of the program's ``copy`` spans
(``Planner._unpermuted``: C's copy to host memory) in the window, per
request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("copy"):
        return None
    return 1e3 * obs.span_s("copy") / obs.requests
