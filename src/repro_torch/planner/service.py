"""The planner service: ``Planner.plan(A, reuse_hint) -> Plan`` and
``Planner.execute(plan, A, B)``, on the device the planner was built for.

Extract features, rank candidates with the amortization-aware cost model,
optionally measure a shortlist on the real matrix, materialize the winner
(permutation + cluster boundaries), and cache the plan under the matrix's
pattern fingerprint so its cost is paid once per pattern. ``execute``
packs the device operands once per (plan, operand values) (see
:mod:`repro_torch.planner.executor`), runs the product — the ``pallas``
scheme through the hand-written kernels, the other four through the
gather/scatter tier — and returns host numpy in the *original* order.

``execute`` accepts ``b=None`` (the paper's A² workload), a second
``HostCSR`` (general SpGEMM) or a dense ``(ncols, width)`` array (the
tall-skinny SpMM workload). With the resilience policy's ladder armed (the
default) a failing execution — a raising pack or kernel, a non-finite
output — degrades down the JAX package's ladder (pallas → fixed →
rowwise) and the circuit breaker quarantines the failing plan.

``execute_chain`` is the chained-product entry point (``A^(hops+1)``):
each hop plans the current sparse intermediate under ``workload="chain"``
and, on pallas hops, runs the sparse-C route so the intermediate goes
``CompactedC → HostCSR`` without a dense matrix — on the card at any
width of C.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.clustering import (DEFAULT_MAX_CLUSTER,
                                         fixed_length_clusters,
                                         hierarchical_clusters,
                                         variable_length_clusters)
from repro_torch.core.formats import HostCSR, compacted_c_csr
from repro_torch.core.reorder import reorder as apply_reorder
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import audit as obs_audit
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner import executor
from repro_torch.planner.cost_model import (Candidate, CostModel,
                                            DEFAULT_CANDIDATES, IDENTITY,
                                            Measurement, ScoredCandidate)
from repro_torch.planner.features import (extract_features, fingerprint,
                                          value_digest)
from repro_torch.planner.plan_cache import (DEFAULT_CACHE_DIR,
                                            DEFAULT_MAX_BYTES, Plan,
                                            PlanCache)
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.errors import (LadderExhaustedError,
                                           NonFiniteOutputError,
                                           ProbeTimeoutError)
from repro_torch.resilience.policy import (ResiliencePolicy, fallback_chain,
                                           get_policy)

__all__ = ["Planner", "default_planner"]

# measured mode probes at most MEASURE_TOP shortlisted candidates, whose
# summed predicted preprocessing stays within MEASURE_BUDGET
# SpGEMM-equivalents; a probe past PROBE_TIMEOUT_S seconds is skipped
MEASURE_TOP = 4
MEASURE_BUDGET = 1.3
PROBE_TIMEOUT_S = 30.0

# the executor cache's key reads the values' digest through this name
_value_digest = value_digest


# ---------------------------------------------------------------------------
# plan materialization: run the chosen reorder + clustering for real
# ---------------------------------------------------------------------------


def _materialize(a: HostCSR, cand: Candidate,
                 max_cluster: int = DEFAULT_MAX_CLUSTER,
                 reorder_cache: Optional[dict] = None
                 ) -> tuple[Optional[np.ndarray], Optional[np.ndarray],
                            int, float]:
    """Returns (perm, boundaries, max_cluster, wall seconds).

    ``reorder_cache`` ({reorder name: (reordered matrix, perm)}) shares a
    materialized reordering across the scheme probes of one planning pass.
    """
    t0 = time.perf_counter()
    perm: Optional[np.ndarray] = None
    boundaries: Optional[np.ndarray] = None
    if cand.scheme == "hierarchical":
        cl = hierarchical_clusters(a, max_cluster_th=max_cluster)
        perm, boundaries = cl.perm, cl.boundaries
    else:
        work = a
        if cand.reorder != "original":
            hit = (reorder_cache or {}).get(cand.reorder)
            if hit is not None:
                work, perm = hit
            else:
                work, perm = apply_reorder(a, cand.reorder)
                if reorder_cache is not None:
                    reorder_cache[cand.reorder] = (work, perm)
        if cand.scheme == "fixed":
            boundaries = fixed_length_clusters(work, max_cluster).boundaries
        elif cand.scheme == "variable":
            boundaries = variable_length_clusters(
                work, max_cluster_th=max_cluster).boundaries
        # "pallas" needs no boundaries: its clusters are the fixed
        # block_r-row blocks of the BCC packing
    return perm, boundaries, max_cluster, time.perf_counter() - t0


def _plan_digest(plan: Plan) -> str:
    """Digest of what determines a plan's packed layout: scheme params,
    the permutation and the cluster boundaries (memoized on the plan)."""
    memo = getattr(plan, "_layout_digest", None)
    if memo is not None:
        return memo
    d = hashlib.blake2b(digest_size=8)
    d.update(f"{plan.reorder}|{plan.scheme}|{plan.max_cluster}".encode())
    if plan.perm is not None:
        d.update(np.ascontiguousarray(plan.perm, dtype=np.int64).tobytes())
    if plan.boundaries is not None:
        d.update(np.ascontiguousarray(plan.boundaries,
                                      dtype=np.int64).tobytes())
    out = d.hexdigest()
    plan._layout_digest = out
    return out


def _copy_down(out: torch.Tensor) -> np.ndarray:
    """``out`` as host numpy, floats as float32.

    The padded grid returns B's dtype: bf16 widens to float32, values
    equal to the JAX package's bfloat16 result (numpy has no bfloat16,
    and ml_dtypes is not a dependency; the README's port section records
    this divergence). From the card, ``out`` widens there (exact) and
    lands in page-locked memory from PyTorch's caching host allocator:
    the array's base holds the block until the caller drops every view of
    it, and the next array of its size then reuses the block without a
    fresh ``cudaHostAlloc`` or first-touch page faults. A block is never
    handed out while an answer still points into it."""
    if out.is_floating_point():
        out = out.float()
    if not out.is_cuda:
        return out.cpu().numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out)
    return host.numpy()


def _to_host(out: torch.Tensor, span) -> np.ndarray:
    """A dense C as float32 host numpy (:func:`_copy_down`), booked on
    ``span`` and counted in ``host_copies``."""
    arr = _copy_down(out)
    span.set(bytes=arr.nbytes, pinned=out.is_cuda)
    obs_metrics.get_registry().counter(
        "host_copies", memory="pinned" if out.is_cuda else "pageable").inc()
    return arr


def _pinned_host_bytes(dev: torch.device) -> int:
    """Bytes of page-locked host memory PyTorch's caching host allocator
    holds, live answers and cached blocks together (0 off the card)."""
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.host_memory_stats().get("allocated_bytes.current",
                                                  0))


class _SingleFlight:
    """Per-key mutual exclusion with refcounted cleanup: concurrent
    planners of the same (fingerprint, workload) serialize, so a burst on
    a cold pattern pays feature extraction + materialization once."""

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: dict = {}      # key -> [lock, refcount]

    @contextlib.contextmanager
    def lock(self, key):
        with self._mu:
            ent = self._locks.get(key)
            if ent is None:
                ent = [threading.Lock(), 0]
                self._locks[key] = ent
            ent[1] += 1
        ent[0].acquire()
        try:
            yield
        finally:
            ent[0].release()
            with self._mu:
                ent[1] -= 1
                if ent[1] == 0:
                    self._locks.pop(key, None)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


class Planner:
    """Feature-driven plan selection with a fingerprint-keyed cache.

    Args:
      cache: a :class:`PlanCache` (defaults to in-memory only).
      cost_model: shared :class:`CostModel` (default: one for ``device``);
        measurements accumulate here.
      calibration: optional fitted
        :class:`~repro_torch.planner.calibration.Calibration` forwarded
        into a default-constructed cost model (ignored when
        ``cost_model`` is given — configure that instance directly).
      pallas_b_dtype: dtype the pallas scheme packs B's live tiles in
        (``None``: float32; ``torch.bfloat16`` halves B's bytes at the
        documented 2e-2 relative bound, fp32 accumulation either way).
      auditor: drift auditor executed plans are recorded into.
      hint_provider: optional ``fingerprint -> int`` resolving
        ``reuse_hint=None``.
      resilience: the :class:`ResiliencePolicy` (ladder, breaker,
        incident log); ``None`` uses the process-global policy, resolved
        per use.
      device: where products run — ``"cuda"`` (default) or ``"cpu"``. A
        CUDA planner without a card raises :class:`RuntimeError`.
    """

    def __init__(self, cache: Optional[PlanCache] = None,
                 cost_model: Optional[CostModel] = None,
                 candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                 calibration=None,
                 pallas_b_dtype: Optional[torch.dtype] = None,
                 auditor: Optional[obs_audit.DriftAuditor] = None,
                 hint_provider: Optional[Callable[[str], int]] = None,
                 resilience: Optional[ResiliencePolicy] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else PlanCache()
        self.auditor = (auditor if auditor is not None
                        else obs_audit.get_auditor())
        self.cost_model = (cost_model if cost_model is not None
                           else CostModel(device=self.device,
                                          calibration=calibration))
        self.pallas_b_dtype = (pallas_b_dtype if pallas_b_dtype is not None
                               else torch.float32)
        self.candidates = tuple(candidates)
        self._resilience = resilience
        self.hint_provider = hint_provider
        self.probe_skips = 0
        # (fingerprint, candidate.key) -> materialization artifacts, so a
        # measured candidate's preprocessing is never run twice
        self._artifacts: dict[tuple[str, str], tuple] = {}
        # fingerprint -> {reorder: (matrix, perm)} shared across one
        # planning pass's probes (dropped with the artifacts)
        self._reorders: dict[str, dict] = {}
        # (plan key, operand values) -> packed device operands
        self.exec_cache = executor.ExecCache(self.device)
        # the front-end's worker threads share one planner: this lock
        # guards the measured-mode artifacts (the plan cache, the exec
        # cache and the drift auditor guard themselves)
        self._state_lock = threading.Lock()
        self._plan_flight = _SingleFlight()

    @property
    def resilience(self) -> ResiliencePolicy:
        """The injected policy, else the process-global one."""
        return (self._resilience if self._resilience is not None
                else get_policy())

    # -- planning ------------------------------------------------------------

    def plan(self, a: HostCSR, reuse_hint: Optional[int] = 1, *,
             measure: bool = False,
             candidates: Optional[Sequence[Candidate]] = None,
             use_cache: bool = True, workload: str = "a2") -> Plan:
        """Choose and materialize a (reorder, scheme) plan for ``a``.

        The identity plan (original order, row-wise) is the implicit
        fallback whenever no candidate amortizes. ``workload`` is ``"a2"``
        (sparse × sparse), ``"spmm"`` (dense tall-skinny B), ``"chain"``
        (one hop of :meth:`execute_chain`, A²-shaped) or ``"batch"`` (a
        block-diagonal pack of several requests' operands, A²-shaped,
        executed once through :meth:`execute_batch`); cache entries are
        workload-keyed, so a pack whose pattern collides with a single
        request's fingerprint still plans apart. Concurrent calls on one
        (fingerprint, workload) single-flight. A cached plan whose (fingerprint, scheme, reorder)
        the circuit breaker has quarantined is planned around, not
        evicted.
        """
        tracer = get_tracer()
        with tracer.span("fingerprint"):
            fp = fingerprint(a)
        if reuse_hint is None:
            reuse_hint = (self.hint_provider(fp)
                          if self.hint_provider is not None else 1)
        with tracer.span("plan", workload=workload,
                         measure=measure) as sp:
            with self._plan_flight.lock((fp, workload)):
                plan = self._plan_impl(a, reuse_hint, fp=fp,
                                       measure=measure,
                                       candidates=candidates,
                                       use_cache=use_cache,
                                       workload=workload)
            sp.set(fingerprint=plan.fingerprint, scheme=plan.scheme,
                   reorder=plan.reorder, cache_hit=plan.from_cache)
        reg = obs_metrics.get_registry()
        reg.counter("plan_total").inc()
        cs = self.cache.stats
        for key in ("hits", "misses", "evictions", "entries", "bytes"):
            reg.gauge(f"plan_cache_{key}").set(cs[key])
        policy = self.resilience
        if policy.ladder:
            reg.gauge("quarantine").set(len(policy.breaker.open_keys()))
        return plan

    def _plan_impl(self, a: HostCSR, reuse_hint: int, *, fp: str,
                   measure: bool,
                   candidates: Optional[Sequence[Candidate]],
                   use_cache: bool, workload: str) -> Plan:
        """:meth:`plan` minus the span/metric/single-flight bookkeeping."""
        reuse_hint = max(int(reuse_hint), 1)
        if workload not in ("a2", "spmm", "chain", "batch"):
            raise ValueError(f"unknown workload '{workload}'")
        # workload-qualified key for cost-model measurements: an identity
        # baseline timed on SpMM must only normalize SpMM probes
        fp_w = fp if workload == "a2" else f"{fp}|{workload}"
        cands = tuple(candidates) if candidates is not None else self.candidates
        policy = self.resilience
        if use_cache:
            hit = self.cache.get(fp, reuse_hint, workload)
            if hit is not None:
                # a quarantined triple's cached plan is bypassed, not
                # evicted (it serves again once the breaker heals), and
                # the re-plan below is not cached over it
                if not policy.allows(fp, hit.scheme, hit.reorder):
                    use_cache = False
                # a per-call candidate restriction must hold on hits too:
                # a cached plan outside the caller's set is replanned
                # fresh (without evicting the general cached plan)
                elif candidates is None or any(
                        c.reorder == hit.reorder and c.scheme == hit.scheme
                        for c in cands) or hit.is_identity:
                    return hit
                else:
                    use_cache = False
        if policy.ladder and policy.breaker.open_keys():
            # plan around quarantined (fingerprint, scheme, reorder)
            # triples; identity stays the implicit fallback either way
            cands = tuple(c for c in cands
                          if policy.allows(fp, c.scheme, c.reorder))
        feats = extract_features(a)
        ranked = self.cost_model.rank(feats, reuse_hint, cands, fp_w,
                                      workload)
        if measure:
            with get_tracer().span("probe", fingerprint=fp,
                                   workload=workload):
                # the identity baseline normalizes every other measurement
                # — probe it even when the caller's candidate set omits it
                probes = [IDENTITY] + [sc.candidate
                                       for sc in self._shortlist(ranked)
                                       if sc.candidate.key != IDENTITY.key]
                for cand_p in probes:
                    if self.cost_model.measurement(fp_w,
                                                   cand_p) is not None:
                        continue
                    try:
                        m = self._measure(a, cand_p, workload=workload)
                    except ProbeTimeoutError:
                        # skip-and-score-heuristically: a pathological
                        # candidate must not wedge the request
                        self.probe_skips += 1
                        obs_metrics.get_registry().counter(
                            "probe_skips").inc()
                        continue
                    self.cost_model.observe(fp_w, cand_p,
                                            m.kernel_s, m.preprocess_s)
            ranked = self.cost_model.rank(feats, reuse_hint, cands, fp_w,
                                          workload)
            # evidence only: an unmeasured candidate's heuristic must not
            # outrank the measured shortlist
            pool = [s for s in ranked if s.measured] or ranked
        else:
            pool = ranked
        chosen = next((s for s in pool if s.amortizes),
                      self.cost_model.score(feats, IDENTITY, reuse_hint,
                                            fp_w, workload))

        cand = chosen.candidate
        with self._state_lock:
            art = self._artifacts.pop((fp_w, cand.key), None)
        if art is None:
            art = _materialize(a, cand,
                               reorder_cache=self._reorders.get(fp))
        perm, boundaries, max_cluster, t_pre = art
        plan = Plan(
            fingerprint=fp, reorder=cand.reorder, scheme=cand.scheme,
            reuse_hint=reuse_hint, max_cluster=max_cluster,
            workload=workload,
            perm=perm, boundaries=boundaries, preprocess_s=t_pre,
            predicted={
                "kernel_rel": chosen.kernel_rel,
                "preprocess_rel": chosen.preprocess_rel,
                "total_rel": chosen.total_rel,
                "break_even": (chosen.break_even
                               if np.isfinite(chosen.break_even) else -1.0),
                "measured": chosen.measured,
            },
            measured={
                s.candidate.key: {"kernel_rel": s.kernel_rel,
                                  "preprocess_rel": s.preprocess_rel}
                for s in ranked if s.measured
            })
        with self._state_lock:                     # drop losers' artifacts
            self._artifacts = {k: v for k, v in self._artifacts.items()
                               if k[0] != fp_w}
            self._reorders.pop(fp, None)
        if use_cache:
            self.cache.put(plan)
        return plan

    def _probe_first(self, s: ScoredCandidate) -> bool:
        """An unmeasured kernel-tier candidate on the card. Its prior
        charges whole tiles where the card's kernels read only live
        columns: for a dense-B SpMM, priced against the JAX package's
        gather cost, that ranks it far behind the gather tier; for a
        sparse B, priced against the card's own gather cost, it ranks
        first. Either way measured mode probes it first and lets the
        measurement decide."""
        return (self.device.type == "cuda" and not s.measured
                and s.candidate.scheme == "pallas")

    def _shortlist(self, ranked: list[ScoredCandidate]
                   ) -> list[ScoredCandidate]:
        """Identity (the baseline anchor) + the candidates worth probing.

        Two gates keep probing cheap: non-amortizing candidates are never
        measured (the break-even rule) — except the kernel tier on the
        card, whose SpMM prior overprices it and which goes first — and the
        cumulative *predicted* preprocessing of the shortlist is capped
        at ``MEASURE_BUDGET`` SpGEMM-equivalents.
        """
        out = [s for s in ranked if s.candidate.key == IDENTITY.key]
        spent = 0.0
        for s in sorted(ranked, key=lambda s: not self._probe_first(s)):
            if len(out) >= MEASURE_TOP:
                break
            if s.candidate.key == IDENTITY.key:
                continue
            if not (s.amortizes or self._probe_first(s)):
                continue
            if spent + s.preprocess_rel > MEASURE_BUDGET:
                continue
            spent += s.preprocess_rel
            out.append(s)
        return out

    # -- direct measurement --------------------------------------------------

    def _measure(self, a: HostCSR, cand: Candidate, *,
                 workload: str = "a2") -> Measurement:
        """Time preprocessing + ``cand``'s best of two device-synced calls
        on ``a`` after a warm one. Past ``PROBE_TIMEOUT_S`` with no timed
        call yet, :class:`ProbeTimeoutError` tells the planning loop to skip
        the candidate; with one call timed the measurement is cut short."""
        t_start = time.perf_counter()

        def check_time() -> None:
            el = time.perf_counter() - t_start
            if el > PROBE_TIMEOUT_S:
                raise ProbeTimeoutError(cand.key, el, PROBE_TIMEOUT_S)

        fp = fingerprint(a)
        fp_w = fp if workload == "a2" else f"{fp}|{workload}"
        with self._state_lock:
            rcache = self._reorders.setdefault(fp, {})
        perm, boundaries, max_cluster, t_pre = _materialize(
            a, cand, reorder_cache=rcache)
        with self._state_lock:
            self._artifacts[(fp_w, cand.key)] = (perm, boundaries,
                                                 max_cluster, t_pre)
        check_time()
        plan = Plan(fingerprint=fp, reorder=cand.reorder, scheme=cand.scheme,
                    reuse_hint=1, max_cluster=max_cluster, perm=perm,
                    boundaries=boundaries, workload=workload)
        # the spmm workload (and any rectangular matrix) probes the
        # tall-skinny dense-B kernels
        probe_b = None
        if workload == "spmm" or a.nrows != a.ncols:
            probe_b = np.asarray(
                np.random.default_rng(0).standard_normal((a.ncols, 32)),
                dtype=np.float32)
        runner = self._build_runner(plan, a, probe_b)
        runner()                                        # build + warm
        check_time()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            runner()
            best = min(best, time.perf_counter() - t0)
            if time.perf_counter() - t_start > PROBE_TIMEOUT_S:
                break                    # one rep banked: cut short, keep it
        return Measurement(kernel_s=best, preprocess_s=t_pre)

    # -- execution -----------------------------------------------------------

    def execute(self, plan: Plan, a: HostCSR,
                b: HostCSR | np.ndarray | None = None) -> np.ndarray:
        """Run the planned product; returns dense C (host numpy) in the
        original order.

        ``b=None`` → A² (the paper workload). A second ``HostCSR`` → A·B
        with A row-permuted only. A dense array → tall-skinny SpMM. The
        packed device operands are cached per (plan, operand values), so
        repeated calls skip packing. Every execution is device-synced and
        its wall time fed to the drift auditor.

        With the resilience policy's ladder armed (the default) the
        product runs under the output guard (a non-finite result raises
        :class:`NonFiniteOutputError`, one float64 sum on the host), and a
        failing execution degrades instead of erroring: the request
        re-runs down the fallback ladder (pallas → fixed clusterwise →
        rowwise identity, all on ``reorder="original"``), the incident is
        recorded and the failing (fingerprint, scheme, reorder) triple is
        quarantined by the circuit breaker, so the next request plans
        around it. Only when every rung fails does
        :class:`LadderExhaustedError` escape. With the ladder off a
        failure propagates as it is."""
        policy = self.resilience
        if not policy.ladder:
            return self._execute_impl(plan, a, b)
        try:
            out = self._guarded_execute(plan, a, b)
        except Exception as e:           # noqa: BLE001 — ladder catches all
            primary = e                  # outlives the except block
        else:
            policy.breaker.record_success(policy.triple(
                plan.fingerprint, plan.scheme, plan.reorder))
            return out
        return self._run_ladder(plan, a, b, primary)

    def execute_batch(self, plan: Plan, a: HostCSR,
                      b: HostCSR | None = None) -> np.ndarray:
        """One block-diagonal batched launch — guarded, but **without**
        the fallback ladder.

        The ladder degrades a *single* request in place; re-running a
        whole batch down the rungs would make every co-batched tenant pay
        for one member's fault, and the identity rung's fault suppression
        would mask which member carried it. So a failing batched launch is
        resolved one level up: the circuit breaker records the failing
        triple, the incident is recorded with ``fallback="unbatch"``, and
        the error propagates so the batcher disbands the group — each
        member then re-runs individually through :meth:`execute`'s full
        ladder. Returns host numpy like :meth:`execute` (device-synced
        before the copy)."""
        policy = self.resilience
        if not policy.ladder:
            return self._execute_impl(plan, a, b)
        try:
            out = self._guarded_execute(plan, a, b)
        except Exception as e:           # noqa: BLE001 — batcher disbands
            self._degraded(plan, e, "unbatch")
            raise
        policy.breaker.record_success(policy.triple(
            plan.fingerprint, plan.scheme, plan.reorder))
        return out

    def _run_ladder(self, plan: Plan, a: HostCSR,
                    b: HostCSR | np.ndarray | None,
                    primary: Exception) -> np.ndarray:
        """Walk the fallback rungs below ``plan.scheme`` after ``primary``
        failed; books the failure (:meth:`_degraded`) with the rung that
        recovers the request, or with none."""
        tracer = get_tracer()
        site = self._classify_failure(primary)
        causes: list[tuple[str, Exception]] = [(plan.scheme, primary)]
        for rung in fallback_chain(plan.scheme):
            fb = self._fallback_plan(plan, rung, a)
            with tracer.span("fallback", fingerprint=plan.fingerprint,
                             from_scheme=plan.scheme, to_scheme=rung,
                             site=site) as sp:
                # the identity rung is the guaranteed-safe floor: under the
                # fault harness it runs fault-suppressed
                try:
                    with (_faults.suppressed() if rung == "rowwise"
                          else contextlib.nullcontext()):
                        out = self._guarded_execute(fb, a, b)
                except Exception as e:   # noqa: BLE001 — ladder walks on
                    causes.append((rung, e))
                    sp.set(recovered=False)
                    continue
                sp.set(recovered=True)
            self._degraded(plan, primary, rung)
            return out
        self._degraded(plan, primary, "")
        raise LadderExhaustedError(plan.scheme, causes) from primary

    def _degraded(self, plan: Plan, error: Exception, fallback: str) -> None:
        """Book a failed execution of ``plan``: the breaker's failure on its
        triple, the incident with ``fallback`` (what served the request
        instead, ``""`` if nothing did) and then ``serve_fallbacks``."""
        policy = self.resilience
        policy.breaker.record_failure(policy.triple(
            plan.fingerprint, plan.scheme, plan.reorder))
        policy.record_incident(
            fingerprint=plan.fingerprint, workload=plan.workload,
            scheme=plan.scheme, reorder=plan.reorder,
            site=self._classify_failure(error), error=error,
            fallback=fallback)
        if fallback:
            obs_metrics.get_registry().counter(
                "serve_fallbacks", scheme=plan.scheme).inc()

    def _guarded_execute(self, plan: Plan, a: HostCSR,
                         b: HostCSR | np.ndarray | None) -> np.ndarray:
        """One execution under the output guard: the fault harness's
        ``output`` site corrupts here, and a non-finite result raises (one
        float64 sum on the host)."""
        out = self._execute_impl(plan, a, b)
        with get_tracer().span("guard"):
            out = _faults.corrupt_output("output", out)
            if not np.isfinite(np.sum(out, dtype=np.float64)):
                raise NonFiniteOutputError(plan.scheme)
        return out

    @staticmethod
    def _classify_failure(e: Exception) -> str:
        if isinstance(e, NonFiniteOutputError):
            return "nonfinite"
        site = getattr(e, "site", None)     # FaultInjectedError carries it
        return site if isinstance(site, str) else "exception"

    def _fallback_plan(self, plan: Plan, rung: str, a: HostCSR) -> Plan:
        """A rung's plan: same fingerprint and workload,
        ``reorder="original"`` (a failing request must not pay a reorder
        on its recovery path). The fixed rung's boundaries are an O(nrows)
        recompute; its packed operands exec-cache like any plan's."""
        if rung == "rowwise":
            return Plan(fingerprint=plan.fingerprint, reorder="original",
                        scheme="rowwise", reuse_hint=plan.reuse_hint,
                        max_cluster=plan.max_cluster,
                        workload=plan.workload)
        perm, boundaries, max_cluster, t_pre = _materialize(
            a, Candidate("original", rung), max_cluster=plan.max_cluster)
        return Plan(fingerprint=plan.fingerprint, reorder="original",
                    scheme=rung, reuse_hint=plan.reuse_hint,
                    max_cluster=max_cluster, workload=plan.workload,
                    perm=perm, boundaries=boundaries, preprocess_s=t_pre)

    def _execute_impl(self, plan: Plan, a: HostCSR,
                      b: HostCSR | np.ndarray | None = None) -> np.ndarray:
        """:meth:`execute` minus the ladder and the output guard."""
        tracer = get_tracer()
        with tracer.span("execute", fingerprint=plan.fingerprint,
                         scheme=plan.scheme, reorder=plan.reorder,
                         workload=plan.workload) as sp:
            runner = self._build_runner(plan, a, b)
            with tracer.span("kernel", scheme=plan.scheme):
                t0 = time.perf_counter()
                out = runner()      # device-synced inside the runner
                kernel_s = time.perf_counter() - t0
            executor.count_product(plan)
            rec = self.auditor.record(plan, kernel_s)
            if tracer.enabled:
                sp.set(kernel_s=kernel_s)
                if rec is not None:
                    sp.set(predicted_rel=rec.predicted_rel,
                           measured_rel=rec.measured_rel,
                           residual=rec.residual)
            return out

    # -- chained products (workload="chain") ---------------------------------

    def execute_chain(self, a: HostCSR, *, hops: int = 2,
                      reuse_hint: Optional[int] = None,
                      measure: bool = False,
                      candidates: Optional[Sequence[Candidate]] = None
                      ) -> tuple[HostCSR, list[Plan]]:
        """Chained sparse product ``A^(hops+1)`` — left-chained hops
        ``C₁ = A·A``, ``C₂ = C₁·A``, … (``hops=2`` is A³).

        Each hop plans the current sparse intermediate under
        ``workload="chain"`` (the plan cache keys on the per-hop
        fingerprint, so a repeated chain hits at every hop). Pallas hops
        run the sparse-C route and feed the ``CompactedC → HostCSR``
        result straight into the next hop; other hops densify and
        re-sparsify. Returns ``(C, plans)``: ``C`` a :class:`HostCSR` in
        the original order, ``plans`` the per-hop plans (``len == hops``).
        """
        if a.nrows != a.ncols:
            raise ValueError("chain workload needs a square matrix")
        hops = int(hops)
        if hops < 1:
            raise ValueError(f"hops must be >= 1, got {hops}")
        if reuse_hint is None and self.hint_provider is None:
            # the chain itself is the reuse unit: expect a handful of
            # repeated chains; with a hint provider None flows through
            reuse_hint = max(hops, 2)
        cur = a
        plans: list[Plan] = []
        tracer = get_tracer()
        hop_counter = obs_metrics.get_registry().counter("chain_hops")
        for k in range(hops):
            with tracer.span("hop", hop=k, hops=hops) as sp:
                t0 = time.perf_counter()
                plan = self.plan(cur, reuse_hint, measure=measure,
                                 candidates=candidates, workload="chain")
                # per-hop planning wall time, for the server's plan_s
                plan.plan_wall_s = time.perf_counter() - t0
                plans.append(plan)
                sp.set(fingerprint=plan.fingerprint, scheme=plan.scheme)
                cur = self._chain_hop(plan, cur, None if k == 0 else a)
            hop_counter.inc()
        return cur, plans

    def _chain_hop(self, plan: Plan, cur: HostCSR,
                   b: Optional[HostCSR]) -> HostCSR:
        """One hop ``cur · (b if b is not None else cur)`` → HostCSR.

        With the ladder armed, a failing sparse-C route degrades to the
        dense :meth:`execute` path (itself ladder-guarded), recording the
        incident and quarantining the triple like any execution failure."""
        if plan.scheme == "pallas":
            try:
                host = self._chain_hop_sparse(plan, cur, b)
            except Exception as e:       # noqa: BLE001 — ladder catches all
                if not self.resilience.ladder:
                    raise
                self._degraded(plan, e, "dense_route")
                host = None
            if host is not None:
                return host
        return HostCSR.from_dense(self.execute(plan, cur, b))

    def _chain_hop_sparse(self, plan: Plan, cur: HostCSR,
                          b: Optional[HostCSR]) -> Optional[HostCSR]:
        """The sparse-C route of a pallas chain hop, or ``None`` when the
        live-pair grid does not apply (on the CPU, a B wider than the
        TPU's strip budget: the dense :meth:`execute` path runs the
        padded grid instead; on the card it applies at any width). The
        pack is exec-cached, under the cache's byte cap, like the dense
        paths'.

        The ``kernel`` span holds the whole runner: the ``product`` (K5
        and the sync), the slabs' ``to_csr`` assembly on the device, the
        CSR arrays' ``copy`` to the host and, where the plan reorders,
        the ``unpermute``. Each product adds its live slabs' bytes and
        C's entries to ``sparse_c_slab_bytes`` and
        ``sparse_c_entries``."""
        bh_cols = (cur if b is None else b).ncols
        dev = self.device
        if not kernel_ops.compact_grid_ok_ncols(bh_cols, sparse_c=True,
                                                device=dev):
            return None
        vk = (_value_digest(cur) if b is None else
              f"{_value_digest(cur)}|{fingerprint(b)}|{_value_digest(b)}")
        ck = (f"{plan.fingerprint}|{_plan_digest(plan)}|chain"
              f"|{'sq' if b is None else 'ab'}|{vk}")
        packed = self.exec_cache.operand(ck, lambda: executor.pack_sparse_b(
            plan, cur, b, device=dev, b_dtype=self.pallas_b_dtype,
            sparse_c=True))
        if packed is None:
            return None
        tracer = get_tracer()
        with tracer.span("kernel", scheme=plan.scheme, variant="sparse_c"):
            with tracer.span("product"):
                t0 = time.perf_counter()
                cc = packed.run(compacted=True)
                synchronize(dev)
                kernel_s = time.perf_counter() - t0
            with tracer.span("to_csr") as sp:
                csr = compacted_c_csr(cc)
                synchronize(dev)
                sp.set(slabs=cc.nslabs_live, c_nnz=int(csr[1].shape[0]))
            with tracer.span("copy") as sp:
                arrays = [_copy_down(t) for t in csr]
                sp.set(bytes=sum(x.nbytes for x in arrays),
                       pinned=dev.type == "cuda")
            host = HostCSR(*arrays, (cc.nrows, cc.ncols))
            if plan.perm is not None:
                with tracer.span("unpermute"):
                    inv = np.argsort(np.asarray(plan.perm, dtype=np.int64))
                    host = (host.permute_symmetric(inv) if b is None
                            else host.permute_rows(inv))
        executor.count_product(plan)
        reg = obs_metrics.get_registry()
        reg.counter("sparse_c_slab_bytes").inc(
            cc.nslabs_live * cc.block_r * cc.bn * cc.slabs.element_size())
        reg.counter("sparse_c_entries").inc(host.nnz)
        self.auditor.record(plan, kernel_s)
        return host

    def _build_runner(self, plan: Plan, a: HostCSR,
                      b: HostCSR | np.ndarray | None):
        """The product's runner: the packed operands from the exec cache,
        or packed and kept there, launched under :meth:`_unpermuted`."""
        dense_b = b is not None and not isinstance(b, HostCSR)
        squared = b is None
        if squared and a.nrows != a.ncols:
            raise ValueError("A² workload needs a square matrix")
        dev = self.device
        tracer = get_tracer()
        # the plan fingerprint is value-independent; the packed operands
        # are not — key them by the operand values (and for a second
        # sparse operand, its pattern too) AND by the plan's layout
        with tracer.span("digest"):
            vk = (_value_digest(a) if squared or dense_b else
                  f"{_value_digest(a)}|{fingerprint(b)}|{_value_digest(b)}")
            pk = f"{plan.fingerprint}|{_plan_digest(plan)}"
            ck = f"{pk}|{'sq' if squared else 'ab'}" \
                 f"|{'dense' if dense_b else 'csr'}|{vk}"
        bd = None
        if dense_b:
            with tracer.span("upload"):
                bd = torch.from_numpy(np.ascontiguousarray(
                    b, dtype=np.float32)).to(dev)
        packed = self.exec_cache.operand(ck, lambda: (
            executor.pack_dense_b(plan, a, cache=self.exec_cache,
                                  pattern_key=pk, device=dev) if dense_b else
            executor.pack_sparse_b(plan, a, b, device=dev,
                                   b_dtype=self.pallas_b_dtype)))
        return self._unpermuted(lambda: packed.run(bd), plan.perm,
                                rows_only=not squared)

    def _unpermuted(self, run, perm: Optional[np.ndarray], *,
                    rows_only: bool):
        """Wrap a device runner: sync the card, copy the result to host
        numpy and undo the plan's permutation there."""
        dev = self.device
        tracer = get_tracer()

        def host() -> np.ndarray:
            with tracer.span("product"):
                out = run()
                synchronize(dev)
            with tracer.span("copy") as sp:
                return _to_host(out, sp)

        if perm is None:
            return host
        p = np.asarray(perm, dtype=np.int64)

        def wrapped() -> np.ndarray:
            cp = host()
            with tracer.span("unpermute"):
                out = np.empty_like(cp)
                if rows_only:
                    out[p] = cp
                else:
                    out[np.ix_(p, p)] = cp
            return out
        return wrapped

    @property
    def stats(self) -> dict:
        return {**self.cache.stats, "exec_entries": len(self.exec_cache),
                "exec_bytes": self.exec_cache.nbytes,
                "probe_skips": self.probe_skips,
                "pinned_host_bytes": _pinned_host_bytes(self.device),
                "resilience": self.resilience.stats}


# ---------------------------------------------------------------------------
# module-level convenience API
# ---------------------------------------------------------------------------


_DEFAULT: Optional[Planner] = None


def default_planner() -> Planner:
    """The process-wide serving planner on the card: plans persist across
    processes in ``experiments/plan_cache_torch/`` (git-ignored) under an
    LRU byte budget. Construct ``Planner()`` directly for an
    in-memory-only instance."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Planner(cache=PlanCache(path=DEFAULT_CACHE_DIR,
                                           max_bytes=DEFAULT_MAX_BYTES))
    return _DEFAULT
