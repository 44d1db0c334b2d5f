"""planner.product_ms: the time of the program's ``product`` spans
(``Planner._unpermuted``: the device product and the sync after it)
in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("product"):
        return None
    return 1e3 * obs.span_s("product") / obs.requests
