"""planner.pack_ms: the time of the program's ``pack`` and
``batch_pack`` spans (operand packing in ``Planner._build_runner`` and
the batcher's block-diagonal pack) in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("pack", "batch_pack"):
        return None
    return 1e3 * obs.span_s("pack", "batch_pack") / obs.requests
