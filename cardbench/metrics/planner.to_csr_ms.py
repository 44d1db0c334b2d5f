"""planner.to_csr_ms: the time of the program's ``to_csr`` spans
(``Planner._chain_hop_sparse``: C's CompactedC slabs, on the host,
assembled into CSR) in the window, per request served."""


def read(obs):
    if obs.requests <= 0 or not obs.has_span("to_csr"):
        return None
    return 1e3 * obs.span_s("to_csr") / obs.requests
