"""Resilience pieces of the serving stack carried into the port: the
error taxonomy (:mod:`repro_torch.resilience.errors`), request-boundary
operand validation (:mod:`repro_torch.resilience.validation`) and the
deterministic fault-injection hooks (:mod:`repro_torch.resilience.faults`).
The degradation ladder, circuit breaker and policy are not ported yet."""
