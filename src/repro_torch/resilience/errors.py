"""Structured exception types of the resilience layer.

These are leaf definitions (no repo-internal imports) so every layer —
``core.formats`` validation, the plan cache, the kernel wrappers, the
serving engine — can raise them without import cycles.
"""
from __future__ import annotations

__all__ = ["InvalidOperandError", "CorruptPlanError", "FaultInjectedError",
           "NonFiniteOutputError", "ProbeTimeoutError",
           "LadderExhaustedError", "OverloadError",
           "DeadlineExceededError"]


class InvalidOperandError(ValueError):
    """A request operand failed structural validation at the serving
    boundary.

    Subclasses ``ValueError`` so pre-existing ``except ValueError``
    call sites keep working. ``field`` names the violated invariant
    class (``indptr`` / ``indices`` / ``data`` / ``shape``) — the
    rejection metric labels on it — and ``detail`` carries the
    machine-readable specifics (offending row, value, bound).
    """

    def __init__(self, field: str, reason: str, **detail):
        self.field = field
        self.reason = reason
        self.detail = dict(detail)
        extra = "".join(f", {k}={v}" for k, v in self.detail.items())
        super().__init__(f"invalid operand [{field}]: {reason}{extra}")


class CorruptPlanError(RuntimeError):
    """An on-disk plan-cache entry failed to deserialize or checksum.

    Never escapes :class:`repro_torch.planner.plan_cache.PlanCache` — a corrupt
    entry is treated as a miss and the file evicted — but the distinct
    type lets the cache separate "damaged bytes" from real I/O errors.
    """

    def __init__(self, path: str, reason: str):
        self.path = path
        self.reason = reason
        super().__init__(f"corrupt plan entry {path}: {reason}")


class FaultInjectedError(RuntimeError):
    """Raised by an armed :class:`repro_torch.resilience.faults.FaultPlan` at an
    injection site — the deterministic stand-in for a kernel build
    failure, a refused launch, or a truncated read."""

    def __init__(self, site: str, fire: int):
        self.site = site
        self.fire = fire
        super().__init__(f"injected fault at site '{site}' (fire #{fire})")


class NonFiniteOutputError(ArithmeticError):
    """The output finiteness guard found NaN/Inf in a produced result —
    the numeric-blowup failure mode the degradation ladder treats
    exactly like an exception from the kernel."""

    def __init__(self, scheme: str):
        self.scheme = scheme
        super().__init__(
            f"non-finite values in output of scheme '{scheme}'")


class ProbeTimeoutError(RuntimeError):
    """A measured-mode probe exceeded its per-candidate wall-clock cap.

    Caught inside :meth:`repro_torch.planner.service.Planner.plan`: the
    candidate is skipped (scored heuristically) and the skip counted in
    ``Planner.stats`` — a pathological candidate must not wedge the
    request.
    """

    def __init__(self, candidate_key: str, elapsed_s: float, cap_s: float):
        self.candidate_key = candidate_key
        self.elapsed_s = elapsed_s
        self.cap_s = cap_s
        super().__init__(
            f"probe of '{candidate_key}' hit the wall-clock cap: "
            f"{elapsed_s:.3f}s > {cap_s:.3f}s")


class OverloadError(RuntimeError):
    """The serving front-end shed a request at admission.

    Raised by :class:`repro_torch.serve.frontend.AsyncSpGEMMServer` when the
    bounded request queue (or the caller's per-tenant depth partition)
    is full — the structured alternative to unbounded queue growth.
    ``reason`` is the admission rule that fired (``capacity`` /
    ``tenant_depth`` / ``shutdown``); ``depth``/``limit`` carry the
    observed and allowed queue depths so clients can back off
    proportionally.
    """

    def __init__(self, reason: str, *, tenant: str = "", depth: int = 0,
                 limit: int = 0):
        self.reason = reason
        self.tenant = tenant
        self.depth = int(depth)
        self.limit = int(limit)
        who = f" tenant '{tenant}'" if tenant else ""
        super().__init__(
            f"overload [{reason}]:{who} queue depth {depth} at limit "
            f"{limit} — request shed")


class DeadlineExceededError(RuntimeError):
    """A request's deadline cannot be (or was not) met.

    ``stage`` names where the deadline fired: ``admission`` (the
    predicted plan+execute cost already exceeds the remaining budget —
    shed before any work), ``queue`` (the budget expired while the
    request waited — shed at dequeue, never executed). Completions that
    overrun their deadline are *not* raised — they are counted in
    ``serve_deadline_miss`` and flagged on the response instead.
    """

    def __init__(self, stage: str, *, deadline_s: float = 0.0,
                 predicted_s: float = 0.0, waited_s: float = 0.0):
        self.stage = stage
        self.deadline_s = float(deadline_s)
        self.predicted_s = float(predicted_s)
        self.waited_s = float(waited_s)
        detail = (f"predicted {predicted_s:.4f}s" if stage == "admission"
                  else f"waited {waited_s:.4f}s")
        super().__init__(
            f"deadline exceeded [{stage}]: budget {deadline_s:.4f}s, "
            f"{detail}")


class LadderExhaustedError(RuntimeError):
    """Every rung of the degradation ladder failed — including the
    identity row-wise oracle. Carries the per-rung causes; reaching this
    means the failure is in the operands or the host, not the scheme."""

    def __init__(self, scheme: str, causes: list):
        self.scheme = scheme
        self.causes = list(causes)
        chain = "; ".join(f"{s}: {type(e).__name__}: {e}"
                          for s, e in self.causes)
        super().__init__(
            f"degradation ladder exhausted for scheme '{scheme}' ({chain})")
