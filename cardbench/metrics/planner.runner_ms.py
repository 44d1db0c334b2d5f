"""planner.runner_ms: the time of the program's span named ``kernel``
(``Planner._execute_impl``), which holds the whole runner: the device
product, the sync, the copy to the host and the un-permutation; per
request served in the window."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("kernel"):
        return None
    return 1e3 * obs.span_s("kernel") / obs.requests
