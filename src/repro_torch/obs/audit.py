"""Cost-model drift auditor: predicted score vs measured wall time, live.

The planner's cost model predicts each plan's ``kernel_rel`` — kernel
time relative to one identity-order row-wise SpGEMM on the same matrix.
Offline, the calibration corpus (``planner/calibration.py``) checks
those predictions against benchmark sweeps; this module closes the same
loop *online*: every ``Planner.execute`` records the executed plan's
prediction next to its measured (device-synced) wall time.

The identity baseline is never run in steady-state serving, so absolute
prediction error is not directly observable. The auditor therefore
keeps, per ``(fingerprint, workload)``, a rolling **implied baseline**
``measured_s / predicted_rel`` (EWMA): when predictions are right, every
scheme executed under a fingerprint implies the same baseline; when a
scheme's prediction drifts, its implied baseline diverges from the
rolling one and the residual

    residual = log(measured_s / baseline_s) - log(predicted_rel)

moves away from zero. An identity execution (``predicted_rel == 1``)
anchors the baseline exactly. Residuals are tracked as

* a rolling per-scheme window (mean |residual| and the one-sided regret
  — mean positive residual, i.e. "slower than predicted"), and
* a per-fingerprint EWMA, flagged when ``|EWMA| > threshold``
  (default 0.4 in log space ≈ a 1.5× prediction error).

:meth:`DriftAuditor.samples` exposes the accumulated records in the
exact row format ``planner/calibration.py::fit_calibration`` consumes
(``{"spec", "reorder", "scheme", "kernel_rel", "preprocess_rel"}``), so
recalibration becomes a cron job over serving traffic instead of a
benchmark run. ``spec`` is ``serve:<fingerprint>`` — not a suite spec
name, so the fit's feature-conditional kernel-scale stage skips these
rows while the preprocess-constant stage consumes them.

The auditor is thread-safe (one re-entrant lock around its state): the
serving front-end's worker threads record into one auditor while its
scheduled recalibration reads the samples.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Optional

__all__ = ["AuditRecord", "DriftAuditor", "get_auditor",
           "DEFAULT_RESIDUAL_THRESHOLD"]

# |log residual| beyond which a fingerprint's prediction is flagged:
# 0.4 ≈ log(1.5), i.e. predicted and measured disagree by ≥ 1.5×
DEFAULT_RESIDUAL_THRESHOLD = 0.4

# EWMA weight of the newest sample for baselines and per-fp residuals
_EWMA = 0.3


@dataclasses.dataclass(frozen=True)
class AuditRecord:
    """One executed plan's prediction-vs-measurement sample."""

    fingerprint: str
    reorder: str
    scheme: str
    workload: str
    predicted_rel: float     # cost model's kernel_rel for the plan
    measured_s: float        # device-synced kernel wall time
    baseline_s: float        # rolling implied identity baseline (seconds)
    measured_rel: float      # measured_s / baseline_s
    residual: float          # log(measured_rel) - log(predicted_rel)
    preprocess_s: float      # plan materialization time (0 on cache hits)
    cache_hit: bool


class DriftAuditor:
    """Rolling prediction-error accounting over executed plans."""

    def __init__(self, threshold: float = DEFAULT_RESIDUAL_THRESHOLD,
                 capacity: int = 4096, window: int = 256):
        self.threshold = float(threshold)
        self.records: deque[AuditRecord] = deque(maxlen=capacity)
        self._baseline: dict[tuple[str, str], float] = {}
        self._fp_residual: dict[str, float] = {}
        self._fp_scheme: dict[str, str] = {}
        self._scheme_residuals: dict[str, deque] = {}
        self._window = int(window)
        self._lock = threading.RLock()

    # -- recording -----------------------------------------------------------

    def record(self, plan, measured_s: float) -> Optional[AuditRecord]:
        """Ingest one executed plan; returns the sample (None if unusable).

        ``plan`` needs the :class:`repro_torch.planner.plan_cache.Plan`
        surface: ``fingerprint``, ``reorder``, ``scheme``, ``workload``,
        ``predicted`` (dict with ``kernel_rel``), ``preprocess_s``,
        ``from_cache``.
        """
        measured_s = float(measured_s)
        if not (measured_s > 0.0 and math.isfinite(measured_s)):
            return None
        with self._lock:
            rec = self._record_locked(plan, measured_s)
            flagged = len(self.flagged())
        from repro_torch.obs.metrics import get_registry
        reg = get_registry()
        reg.counter("audit_records").inc()
        reg.gauge("audit_flagged").set(flagged)
        return rec

    def _record_locked(self, plan, measured_s: float) -> AuditRecord:
        pred = float((plan.predicted or {}).get("kernel_rel", 1.0))
        if not (pred > 0.0 and math.isfinite(pred)):
            pred = 1.0
        key = (plan.fingerprint, plan.workload)
        implied = measured_s / pred
        base = self._baseline.get(key)
        if base is None:
            # first sample seeds the baseline: residual is 0 by
            # construction, drift shows from the second sample on
            base = implied
        measured_rel = measured_s / base
        residual = math.log(measured_rel) - math.log(pred)
        self._baseline[key] = (1.0 - _EWMA) * base + _EWMA * implied
        rec = AuditRecord(
            fingerprint=plan.fingerprint, reorder=plan.reorder,
            scheme=plan.scheme, workload=plan.workload,
            predicted_rel=pred, measured_s=measured_s, baseline_s=base,
            measured_rel=measured_rel, residual=residual,
            preprocess_s=float(plan.preprocess_s),
            cache_hit=bool(plan.from_cache))
        self.records.append(rec)
        prev = self._fp_residual.get(plan.fingerprint)
        self._fp_residual[plan.fingerprint] = (
            residual if prev is None
            else (1.0 - _EWMA) * prev + _EWMA * residual)
        self._fp_scheme[plan.fingerprint] = plan.scheme
        self._scheme_residuals.setdefault(
            plan.scheme, deque(maxlen=self._window)).append(residual)
        return rec

    # -- views ---------------------------------------------------------------

    def flagged(self, threshold: Optional[float] = None) -> dict:
        """Fingerprints whose rolling |residual| exceeds the threshold:
        {fingerprint: {"residual", "scheme"}} — these are the patterns
        whose plans rest on a drifted prediction and should be
        re-measured (or the model recalibrated)."""
        th = self.threshold if threshold is None else float(threshold)
        with self._lock:
            return {fp: {"residual": r,
                         "scheme": self._fp_scheme.get(fp, "")}
                    for fp, r in self._fp_residual.items() if abs(r) > th}

    def summary(self) -> dict:
        """Per-scheme rolling drift table (the ``stats()`` view):
        sample count, mean |residual|, one-sided regret (mean positive
        residual — "slower than predicted"), plus totals and the flagged
        set."""
        per_scheme = {}
        with self._lock:
            for scheme, resid in sorted(self._scheme_residuals.items()):
                rs = list(resid)
                per_scheme[scheme] = {
                    "n": len(rs),
                    "mean_abs_residual": sum(abs(r) for r in rs) / len(rs),
                    "regret": sum(max(r, 0.0) for r in rs) / len(rs),
                }
            return {"records": len(self.records),
                    "fingerprints": len(self._fp_residual),
                    "threshold": self.threshold,
                    "per_scheme": per_scheme,
                    "flagged": self.flagged()}

    def samples(self) -> list[dict]:
        """Accumulated records in ``fit_calibration``'s row format.

        ``kernel_rel`` is the measured relative (vs the rolling implied
        baseline), ``preprocess_rel`` the materialization time on the
        same scale (0 for cache-hit executions). Feed via
        ``fit_calibration(samples=auditor.samples())``.
        """
        with self._lock:
            records = list(self.records)
        out = []
        for r in records:
            pre_rel = (r.preprocess_s / r.baseline_s
                       if r.baseline_s > 0 else 0.0)
            out.append({"spec": f"serve:{r.fingerprint}",
                        "reorder": r.reorder, "scheme": r.scheme,
                        "kernel_rel": r.measured_rel,
                        "preprocess_rel": pre_rel})
        return out

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self._baseline.clear()
            self._fp_residual.clear()
            self._fp_scheme.clear()
            self._scheme_residuals.clear()


_AUDITOR = DriftAuditor()


def get_auditor() -> DriftAuditor:
    """The process-global auditor the serving path records into."""
    return _AUDITOR
