"""Learned cost-model calibration, fitted from measured samples.

The heuristic layer of :mod:`repro_torch.planner.cost_model` predicts
``kernel_rel`` / ``preprocess_rel`` from hand-tuned constants.
:func:`fit_calibration` solves two small least-squares problems over
measured samples and returns a :class:`Calibration` the
:class:`~repro_torch.planner.cost_model.CostModel` applies on top of the
heuristic —

* **kernel scale** — per scheme, the through-origin least-squares slope of
  measured ``kernel_rel`` against the heuristic's prediction (both are
  ratios to the same identity baseline). Scales are re-normalized by the
  row-wise slope so the identity candidate keeps its defining
  ``kernel_rel == 1``; the break-even gate is untouched.
* **preprocess constants** — the additive ``_REORDER_PRE[r] +
  _SCHEME_PRE[s]`` model refit by linear least squares over an indicator
  design matrix (hierarchical's ``similar_frac`` feature term is
  subtracted from its samples first, as in the heuristic).

The samples come from the caller — the serving front-end passes the drift
auditor's live records (``fit_calibration(samples=auditor.samples())``)
— or, by default, from the port's own sweep cache
(:data:`repro_torch.benchlib.CACHE_PATH`), read for the card's generation
tag only (:func:`repro_torch.benchlib.kernel_gen`): a CPU timing in that
cache never reaches the card's fit. The JAX package's cache and its
committed benchmark artifacts hold TPU and CPU measurements and are never
read. Hand-tuned values remain the fallback: with fewer than
``min_samples`` samples the fit returns ``None``, and any key seen fewer
than ``min_key_samples`` times keeps its hand-tuned constant.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

__all__ = ["Calibration", "fit_calibration"]

# safety clamp: a fitted slope outside this band says the sample set is
# degenerate (one family dominating), not that the heuristic is 4x wrong
_SCALE_LO, _SCALE_HI = 0.25, 4.0


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted corrections applied on top of the heuristic layer."""

    kernel_scale: dict          # scheme -> multiplicative slope (rowwise ≡ 1)
    preprocess_reorder: dict    # reorder -> fitted _REORDER_PRE override
    preprocess_scheme: dict     # scheme -> fitted _SCHEME_PRE override
    n_samples: int              # total (matrix, candidate) kernel samples

    def describe(self) -> dict:
        return {"n_samples": self.n_samples,
                "kernel_scale": dict(self.kernel_scale),
                "preprocess_reorder": dict(self.preprocess_reorder),
                "preprocess_scheme": dict(self.preprocess_scheme)}


def _load_cache_samples(cache_path: str, kernel_gen: str) -> list[dict]:
    """(spec, reorder, scheme, kernel_rel, preprocess_rel) rows from the
    benchlib sweep cache, normalized by each spec's identity baseline;
    only A² rows of generation ``kernel_gen`` are read."""
    if not os.path.exists(cache_path):
        return []
    with open(cache_path) as f:
        raw = json.load(f)
    by_spec: dict[str, dict[tuple[str, str], dict]] = {}
    for key, res in raw.items():
        parts = key.split("|")
        if len(parts) != 5:
            continue
        spec, algo, scheme, workload, gen = parts
        if workload != "a2" or gen != kernel_gen:
            continue
        by_spec.setdefault(spec, {})[(algo, scheme)] = res
    out = []
    for spec, cands in by_spec.items():
        base = cands.get(("original", "rowwise"))
        if not base or base.get("kernel_s", 0) <= 0:
            continue
        bk = float(base["kernel_s"])
        for (algo, scheme), res in cands.items():
            if (algo, scheme) == ("original", "rowwise"):
                continue
            out.append({"spec": spec, "reorder": algo, "scheme": scheme,
                        "kernel_rel": float(res["kernel_s"]) / bk,
                        "preprocess_rel": float(res["preprocess_s"]) / bk})
    return out


def fit_calibration(cache_path: str | None = None,
                    artifacts_dir: str | None = None, *,
                    tier: str = "quick",
                    min_samples: int = 8,
                    min_key_samples: int = 3,
                    samples: list[dict] | None = None):
    """Fit a :class:`Calibration` from measured samples.

    ``samples`` are pre-normalized rows ``{"spec", "reorder", "scheme",
    "kernel_rel", "preprocess_rel"}`` (the drift auditor's
    :meth:`~repro_torch.obs.audit.DriftAuditor.samples` format); a
    ``spec`` naming a suite entry contributes to the kernel slopes, any
    other (``serve:<fingerprint>``) to the preprocessing constants only.
    Without ``samples`` the rows of the card's generation tag are read
    from the benchlib sweep cache at ``cache_path`` (default
    :data:`repro_torch.benchlib.CACHE_PATH`). ``artifacts_dir`` and
    ``tier`` name the JAX package's trajectory artifacts: there are none
    for the card, so nothing is read from them. Returns ``None`` when
    fewer than ``min_samples`` samples exist — the hand-tuned constants
    stay authoritative.
    """
    from repro_torch import benchlib
    from repro_torch.core.suite import SUITE, generate
    from repro_torch.planner.cost_model import (_REORDER_PRE, _SCHEME_PRE,
                                                Candidate, CostModel)
    from repro_torch.planner.features import extract_features

    del artifacts_dir, tier
    if samples is None:
        samples = _load_cache_samples(
            benchlib.CACHE_PATH if cache_path is None else cache_path,
            benchlib.kernel_gen("cuda"))
    if len(samples) < min_samples:
        return None

    # features per spec, computed once (the expensive part of the fit)
    spec_by_name = {s.name: s for s in SUITE}
    feats: dict[str, object] = {}

    def _features(spec_name: str):
        if spec_name not in feats:
            spec = spec_by_name.get(spec_name)
            feats[spec_name] = (extract_features(generate(spec))
                                if spec is not None else None)
        return feats[spec_name]

    # -- kernel scale: per-scheme through-origin least squares --------------
    # the kernel tier is left out, as in the JAX package: its CPU heuristic
    # is a routing gate (the interpret penalty), not a prediction
    model = CostModel(device="cpu")
    pred_meas: dict[str, list[tuple[float, float]]] = {}
    for s in samples:
        f = _features(s["spec"])
        if f is None or s["scheme"] == "pallas":
            continue
        try:
            pred, _ = model._heuristic(f, Candidate(s["reorder"],
                                                    s["scheme"]))
        except ValueError:
            continue
        pred_meas.setdefault(s["scheme"], []).append(
            (pred, s["kernel_rel"]))
    kernel_scale: dict[str, float] = {}
    for scheme, pm in pred_meas.items():
        if len(pm) < min_key_samples:
            continue
        p = np.asarray([x[0] for x in pm], dtype=np.float64)
        m = np.asarray([x[1] for x in pm], dtype=np.float64)
        denom = float((p * p).sum())
        if denom <= 0:
            continue
        kernel_scale[scheme] = float(np.clip((p * m).sum() / denom,
                                             _SCALE_LO, _SCALE_HI))
    # identity must keep kernel_rel == 1: normalize by the rowwise slope
    rw = kernel_scale.get("rowwise")
    if rw:
        kernel_scale = {k: float(np.clip(v / rw, _SCALE_LO, _SCALE_HI))
                        for k, v in kernel_scale.items()}

    # -- preprocess constants: additive indicator least squares -------------
    rows, meas = [], []
    reorders = sorted({s["reorder"] for s in samples})
    schemes = sorted({s["scheme"] for s in samples})
    r_pos = {r: i for i, r in enumerate(reorders)}
    s_pos = {s: len(reorders) + i for i, s in enumerate(schemes)}
    counts: dict[str, int] = {}
    for s in samples:
        y = s["preprocess_rel"]
        if s["scheme"] == "hierarchical":
            f = _features(s["spec"])
            if f is None:
                continue
            y -= f.similar_frac       # the feature-driven term of the model
        x = np.zeros(len(reorders) + len(schemes))
        x[r_pos[s["reorder"]]] = 1.0
        x[s_pos[s["scheme"]]] = 1.0
        rows.append(x)
        meas.append(y)
        counts[s["reorder"]] = counts.get(s["reorder"], 0) + 1
        counts[s["scheme"]] = counts.get(s["scheme"], 0) + 1
    preprocess_reorder: dict[str, float] = {}
    preprocess_scheme: dict[str, float] = {}
    if len(rows) >= min_samples:
        sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(meas),
                                  rcond=None)
        # the indicator design is rank-deficient by one (a constant can
        # shift between the reorder and scheme columns); re-anchor it at
        # the identity convention _REORDER_PRE["original"] == 0
        if "original" in r_pos:
            c = sol[r_pos["original"]]
            sol[: len(reorders)] -= c
            sol[len(reorders):] += c
        sol = np.maximum(sol, 0.0)
        for r in reorders:
            if counts.get(r, 0) >= min_key_samples and r in _REORDER_PRE:
                preprocess_reorder[r] = float(sol[r_pos[r]])
        for sc in schemes:
            if counts.get(sc, 0) >= min_key_samples and sc in _SCHEME_PRE:
                preprocess_scheme[sc] = float(sol[s_pos[sc]])
        # identity anchors stay the exact hand-tuned zeros: the break-even
        # convention "identity amortizes by definition" must survive any fit
        preprocess_reorder.pop("original", None)
        preprocess_scheme.pop("rowwise", None)

    return Calibration(kernel_scale=kernel_scale,
                       preprocess_reorder=preprocess_reorder,
                       preprocess_scheme=preprocess_scheme,
                       n_samples=len(samples))
