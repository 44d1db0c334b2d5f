"""planner.plan_ms: the time of the program's ``plan`` spans
(``Planner.plan``: fingerprint, plan cache, features, prior,
preprocessing) in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("plan"):
        return None
    return 1e3 * obs.span_s("plan") / obs.requests
