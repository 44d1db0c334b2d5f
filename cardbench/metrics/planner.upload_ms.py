"""planner.upload_ms: the time of the program's ``upload`` spans
(``Planner._build_runner``: a dense B's copy to the device) in the
window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("upload"):
        return None
    return 1e3 * obs.span_s("upload") / obs.requests
