"""Cross-request batching: distinct small SpGEMMs in one launch.

The front-end's coalescing dedupes *identical* requests; this module
amortizes dispatch across *distinct* ones. The paper's central
lesson is that SpGEMM on small/irregular inputs is dispatch- and
bandwidth-bound — for sub-threshold matrices the fixed per-launch cost
rivals the kernel work itself, so N queued small requests pay N× for
overhead that one launch could carry. The batcher packs a compatible
group's operands into one block-diagonal A (and B) via
:func:`repro_torch.core.formats.block_diag_csr`, plans the pack once under
``workload="batch"`` (its own fingerprint, its own plan-cache partition),
executes one planner-routed launch, and slices the product back per
ticket — the diagonal blocks of a block-diagonal product are *exactly*
the member products, so the split is a copy, not a computation. On a
``pallas`` plan the launch is one of the hand-written window kernel
(dense strips or CompactedC slabs, as the pack's C window density
routes it).

Exactness: the cross blocks of the pack are structurally zero, so a
member's entries see only its own terms, but on the kernel tier a
member's 8-row blocks and k-tiles move with its row and column offsets,
so its fp32 sums may be formed in another order than the member alone
would use. Integer-valued operands (small integers sum exactly in fp32
in any order) are bit-identical batched and unbatched on every route;
the gather/scatter schemes sum each row in the member's own column order
and are bit-identical on any values.

Failure isolation: a faulted batched launch is **disbanded**, never
laddered — :meth:`repro_torch.planner.service.Planner.execute_batch` records
the breaker failure and the ``fallback="unbatch"`` incident, and
:meth:`Batcher.execute` returns ``None`` so the front-end re-runs every
member individually through the full degradation ladder. One
tenant's poisoned operand can cost co-batched tenants a wasted launch,
never a wrong (or missing) result.

The break-even decision lives in the cost model
(:func:`repro_torch.planner.cost_model.batch_break_even`), not here: the
batcher asks, the constants decide.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.formats import HostCSR, block_diag_csr, split_block_diag
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.cost_model import batch_break_even
from repro_torch.resilience.errors import InvalidOperandError
from repro_torch.resilience.validation import validate_request_pair
from repro_torch.serve.engine import SpGEMMResponse
from repro_torch.serve.queue import QueuedRequest

__all__ = ["BatchPolicy", "Batcher", "batchable", "compatible",
           "BATCH_METRICS"]

# the metric names this layer emits (each described in
# ``obs/metrics.py``'s catalog)
BATCH_METRICS = ("serve_batches", "batch_occupancy",
                 "batch_launch_amortization")


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """What the front-end is allowed to pack into one launch.

    ``max_member_rows`` is the sub-threshold bar: a matrix big enough to
    saturate a launch on its own gains nothing from co-batching and
    would dominate the pack's wall time (a deadline hazard for the small
    members riding along). ``max_total_rows`` bounds the packed operand
    so one batch cannot blow the device working set that N singles would
    have streamed through sequentially.
    """

    enabled: bool = True
    min_members: int = 2               # below this, run singles
    max_members: int = 8               # group size cap per launch
    max_member_rows: int = 256         # "sub-threshold" bar per member
    max_total_rows: int = 2048         # packed operand bound


def batchable(req: QueuedRequest, policy: BatchPolicy) -> bool:
    """Whether one request is eligible for block-diagonal packing.

    Chain requests (``hops``) and dense-B SpMM are excluded — their
    results are not diagonal blocks of a packed product (a chain
    re-fingerprints per hop; a dense B has no column band to own).
    Sparse A·B pairs and square A² requests qualify when the member is
    sub-threshold. Requests already routed to the identity rung by an
    admission downgrade keep their guaranteed-cheap single path.
    """
    if not policy.enabled or req.hops is not None or req.downgrade:
        return False
    a = req.a
    if not isinstance(a, HostCSR) or a.nrows > policy.max_member_rows:
        return False
    if req.b is None:
        return a.nrows == a.ncols          # A² needs square members
    return isinstance(req.b, HostCSR)      # sparse A·B packs; dense B not


def compatible(head: QueuedRequest, req: QueuedRequest) -> bool:
    """Whether ``req`` can share ``head``'s pack: same operand kind —
    A² members and A·B members never mix (their products split on
    different column offsets)."""
    return (req.b is None) == (head.b is None)


class Batcher:
    """Packs a dequeued group, runs one launch, splits per ticket.

    Owns no queue and no threads — the front-end's pump hands it the
    group :meth:`repro_torch.serve.queue.BoundedRequestQueue.take_group`
    drained. ``planner`` is the front-end's (shared plan cache, shared
    resilience policy), so a recurring batch composition is a plan-cache
    hit like any recurring single pattern.
    """

    def __init__(self, planner, *, tenant: str = "",
                 clock: Optional[Callable[[], float]] = None):
        self.planner = planner
        self.tenant = tenant
        self.clock = clock if clock is not None else time.monotonic

    def execute(self, group: list[QueuedRequest]
                ) -> list[tuple[QueuedRequest, object]]:
        """One batched launch for ``group``.

        Returns ``[(request, outcome), …]`` in group order, where each
        outcome is one of

        * a :class:`SpGEMMResponse` — the member's bit-identical slice
          of the batched product;
        * an :class:`InvalidOperandError` — the member failed boundary
          validation (same structured reject + accounting the unbatched
          boundary produces) and was excluded from the pack, so one
          malformed operand never reaches the shared launch;
        * ``None`` — run this member individually: the break-even rule
          declined the group, or the batched launch itself failed (the
          disband path — ``execute_batch`` already recorded the breaker
          failure and the ``fallback="unbatch"`` incident; each single
          then climbs the full degradation ladder on its own).
        """
        reg = obs_metrics.get_registry()
        policy = self.planner.resilience
        rejected: list[tuple[QueuedRequest, object]] = []
        valid: list[QueuedRequest] = []
        for req in group:
            try:
                if policy.validate:
                    validate_request_pair(req.a, req.b,
                                          skip=policy.is_validated)
            except InvalidOperandError as e:
                policy.rejects += 1
                reg.counter("serve_rejects", tenant=req.tenant,
                            field=e.field).inc()
                rejected.append((req, e))
                continue
            if policy.validate:
                policy.mark_validated(req.a)
                if req.b is not None and hasattr(req.b, "indptr"):
                    policy.mark_validated(req.b)
            valid.append(req)
        singles = rejected + [(r, None) for r in valid]
        if not valid or not batch_break_even(len(valid)):
            return singles
        sq = valid[0].b is None
        tracer = get_tracer()
        with tracer.span("batch", members=len(valid),
                         tenant=self.tenant) as sp:
            try:
                with tracer.span("batch_pack", members=len(valid)):
                    apack = block_diag_csr([r.a for r in valid])
                    bpack = (None if sq
                             else block_diag_csr([r.b for r in valid]))
                t0 = time.perf_counter()
                # the pack's own reuse: the max member hint — a batch
                # that contains one hot pattern recurs at least that often
                hint = max([r.reuse_hint or 1 for r in valid] + [1])
                plan = self.planner.plan(apack.host, hint,
                                         workload="batch")
                t1 = time.perf_counter()
                # host numpy: the planner syncs the card before its copy,
                # so t1 → t2 holds the device work and the copy
                out = self.planner.execute_batch(
                    plan, apack.host, None if sq else bpack.host)
                t2 = time.perf_counter()
            except Exception:     # noqa: BLE001 — disband, singles recover
                reg.counter("serve_batches", outcome="disbanded").inc()
                sp.set(disbanded=True)
                return singles
            sp.set(fingerprint=plan.fingerprint, scheme=plan.scheme,
                   cache_hit=plan.from_cache)
        parts = split_block_diag(np.asarray(out), apack,
                                 None if sq else bpack)
        reg.counter("serve_batches", outcome="served").inc()
        reg.histogram("batch_occupancy").observe(float(len(valid)))
        plan_s, exec_s = (t1 - t0) / len(valid), (t2 - t1) / len(valid)
        served: list[tuple[QueuedRequest, object]] = list(rejected)
        for req, block in zip(valid, parts):
            # per-request serve_* histograms mirror the unbatched
            # boundary; plan/execute wall time is apportioned evenly —
            # the launch is shared, so is its cost
            resp = SpGEMMResponse(
                result=block, fingerprint=req.fingerprint,
                reorder=plan.reorder, scheme=plan.scheme,
                workload="a2", plan_cache_hit=plan.from_cache,
                plan_s=plan_s, execute_s=exec_s,
                batched=True, batch_size=len(valid))
            reg.counter("serve_requests", tenant=req.tenant).inc()
            reg.histogram("serve_request_s", tenant=req.tenant,
                          scheme=plan.scheme).observe(plan_s + exec_s)
            reg.histogram("serve_plan_s",
                          tenant=req.tenant).observe(plan_s)
            reg.histogram("serve_execute_s",
                          tenant=req.tenant).observe(exec_s)
            served.append((req, resp))
        return served
