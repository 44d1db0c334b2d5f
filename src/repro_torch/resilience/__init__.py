"""Resilience of the serving stack, carried into the port from the JAX
package (numpy only):

* :mod:`repro_torch.resilience.errors` — the error taxonomy;
* :mod:`repro_torch.resilience.validation` — request-boundary operand
  validation;
* :mod:`repro_torch.resilience.policy` — the degradation ladder
  (pallas → fixed clusterwise → rowwise identity), the per-layer guard
  switches and the bounded incident log;
* :mod:`repro_torch.resilience.breaker` — the circuit breaker that
  quarantines failing (fingerprint, scheme, variant) triples;
* :mod:`repro_torch.resilience.faults` — the deterministic, seeded
  fault-injection hooks.
"""
from repro_torch.resilience.breaker import CircuitBreaker
from repro_torch.resilience.errors import (CorruptPlanError,
                                           DeadlineExceededError,
                                           FaultInjectedError,
                                           InvalidOperandError,
                                           LadderExhaustedError,
                                           NonFiniteOutputError,
                                           OverloadError, ProbeTimeoutError)
from repro_torch.resilience.faults import FaultPlan, arm, disarm, injected
from repro_torch.resilience.policy import (FALLBACK_LADDER, Incident,
                                           ResiliencePolicy, Watermarks,
                                           fallback_chain, get_policy,
                                           reset_policy, set_policy)
from repro_torch.resilience.validation import (validate_dense_operand,
                                               validate_host_csr,
                                               validate_request_pair)

__all__ = [
    "InvalidOperandError", "CorruptPlanError", "FaultInjectedError",
    "NonFiniteOutputError", "ProbeTimeoutError", "LadderExhaustedError",
    "OverloadError", "DeadlineExceededError",
    "CircuitBreaker",
    "FaultPlan", "arm", "disarm", "injected",
    "FALLBACK_LADDER", "fallback_chain", "Incident", "ResiliencePolicy",
    "Watermarks", "get_policy", "set_policy", "reset_policy",
    "validate_host_csr", "validate_dense_operand", "validate_request_pair",
]
