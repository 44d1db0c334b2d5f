"""serve.validate_ms: the time of the program's ``validate`` spans
(``SpGEMMServer.submit``: the operands' validation and its memo) in
the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("validate"):
        return None
    return 1e3 * obs.span_s("validate") / obs.requests
