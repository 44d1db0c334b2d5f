"""Planner-driven sparse pipeline stages.

A pipeline is the canonical amortization case: each stage's sparse matrix
multiplies *every* microbatch of *every* pass, so ``reuse_hint =
microbatches × passes`` and the planner picks a scheme per stage
(:func:`plan_pipeline_stages`) instead of the pipeline hardcoding one.
:func:`pipeline_spmm_apply` then runs the microbatches through the planned
stages on the planner's device, one (F, M·B) SpMM per stage — the schedule
the JAX package's ``pipeline_apply`` runs spatially over a ``pipe`` mesh,
here in order on one card. Bubble fraction of that spatial schedule:
:func:`bubble_fraction`.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.formats import HostCSR
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.plan_cache import Plan
from repro_torch.planner.service import Planner, default_planner

__all__ = ["bubble_fraction", "plan_pipeline_stages", "pipeline_spmm_apply"]


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle share of a GPipe fill/drain schedule: (P-1)/(M+P-1).

    >>> bubble_fraction(4, 6)
    0.3333333333333333
    """
    return (num_stages - 1) / (num_stages + num_microbatches - 1)


def plan_pipeline_stages(stage_mats: Sequence[HostCSR],
                         num_microbatches: int, *,
                         passes: int = 1,
                         planner: Optional[Planner] = None,
                         measure: bool = False) -> list[Plan]:
    """Plan every stage's sparse operator for pipelined reuse.

    Each stage matrix is applied to all ``num_microbatches × passes``
    microbatch activations, so that product is the stage's amortization
    budget. Stages sharing a sparsity pattern hit the same cached plan.
    Defaults to the process-wide planner (on the card) so plans and packed
    formats persist across calls; pass the same explicit planner to both
    this and :func:`pipeline_spmm_apply` to isolate them.
    """
    planner = planner if planner is not None else default_planner()
    reuse = max(num_microbatches * passes, 1)
    tracer = get_tracer()
    # the stages apply sparse weights to dense activations — the
    # tall-skinny workload, so plans are scored (and in measured mode,
    # probed) on the SpMM menu, not A² proxies
    plans = []
    for i, m in enumerate(stage_mats):
        with tracer.span("stage", stage=i, phase="plan") as sp:
            plan = planner.plan(m, reuse, measure=measure, workload="spmm")
            sp.set(scheme=plan.scheme, fingerprint=plan.fingerprint)
        plans.append(plan)
    return plans


def pipeline_spmm_apply(plans: Sequence[Plan],
                        stage_mats: Sequence[HostCSR],
                        x: np.ndarray, *,
                        planner: Optional[Planner] = None) -> np.ndarray:
    """Run microbatches through planned sparse stages.

    Args:
      plans: per-stage plans from :func:`plan_pipeline_stages`.
      stage_mats: per-stage square (F, F) ``HostCSR`` operators.
      x: (M, B, F) microbatched activations.

    Returns (M, B, F) float32 on the host: each microbatch after
    ``y = A_s @ y`` for every stage ``s`` in order. The packed per-stage
    formats live in the planner's execute cache, so all microbatches of
    all passes reuse one packing.
    """
    if len(plans) != len(stage_mats):
        raise ValueError("one plan per stage required")
    planner = planner if planner is not None else default_planner()
    m, bsz, feat = x.shape
    acts = np.asarray(x, dtype=np.float32)
    tracer = get_tracer()
    stage_hist = obs_metrics.get_registry().histogram("pipeline_stage_s")
    for i, (plan, mat) in enumerate(zip(plans, stage_mats)):
        if mat.nrows != mat.ncols or mat.ncols != feat:
            raise ValueError("stage matrices must be (F, F)")
        with tracer.span("stage", stage=i, phase="execute",
                         scheme=plan.scheme):
            t0 = time.perf_counter()
            # one (F, M·B) SpMM per stage: microbatches ride the dense
            # width; Planner.execute returns the result on the host, so
            # the card's work is inside the stage's time
            flat = acts.reshape(m * bsz, feat).T        # (F, M·B)
            out = planner.execute(plan, mat, flat)      # (F, M·B)
            acts = out.T.reshape(m, bsz, feat)
            stage_hist.observe(time.perf_counter() - t0)
    return acts
