"""The planner service: ``plan_spgemm(A, reuse_hint) -> Plan`` and
``execute(plan, A, B)``, on the device the planner was built for.

Extract features, rank candidates with the amortization-aware cost model,
optionally measure a shortlist on the real matrix, materialize the winner
(permutation + cluster boundaries), and cache the plan under the matrix's
pattern fingerprint so its cost is paid once per pattern. ``execute``
packs the device operands once per (plan, operand values), runs the
product — the ``pallas`` scheme through the hand-written window kernel,
the other four through the gather/scatter tier — and returns host numpy
in the *original* row/column order.

``execute`` accepts ``b=None`` (the paper's A² workload), a second
``HostCSR`` (general SpGEMM) or a dense ``(ncols, width)`` array (the
tall-skinny SpMM workload). With the resilience policy's ladder armed (the
default) a failing execution — a raising pack or kernel, a non-finite
output — degrades down the JAX package's ladder (pallas → fixed →
rowwise) and the circuit breaker quarantines the failing plan.

``execute_chain`` is the chained-product entry point (``A^(hops+1)``):
each hop plans the current sparse intermediate under ``workload="chain"``
and, on pallas hops, runs the sparse-C route so the intermediate goes
``CompactedC → HostCSR`` without a dense matrix.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import inspect
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.clustering import (DEFAULT_MAX_CLUSTER,
                                         fixed_length_clusters,
                                         hierarchical_clusters,
                                         variable_length_clusters)
from repro_torch.core.formats import (HostCSR, bcc_from_host,
                                      compacted_c_to_host,
                                      csr_cluster_from_host, csr_from_host,
                                      select_block_k, tiled_csr_from_host)
from repro_torch.core.reorder import reorder as apply_reorder
from repro_torch.core.spgemm import (length_bins, slot_rows_host,
                                     spgemm_clusterwise_dense_binned,
                                     spgemm_rowwise_dense_binned,
                                     spmm_clusterwise, spmm_rowwise)
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs import audit as obs_audit
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.cost_model import (Candidate, CostModel,
                                            DEFAULT_CANDIDATES, IDENTITY,
                                            Measurement, ScoredCandidate)
from repro_torch.planner.features import extract_features, fingerprint
from repro_torch.planner.plan_cache import (DEFAULT_CACHE_DIR,
                                            DEFAULT_MAX_BYTES, Plan,
                                            PlanCache)
from repro_torch.resilience import faults as _faults
from repro_torch.resilience.errors import (LadderExhaustedError,
                                           NonFiniteOutputError,
                                           ProbeTimeoutError)
from repro_torch.resilience.policy import (ResiliencePolicy, fallback_chain,
                                           get_policy)

__all__ = ["Planner", "plan_spgemm", "execute", "execute_chain",
           "default_planner", "reset_default_planner"]


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


def _tensor_nbytes(obj) -> int:
    """Bytes of the tensors an exec-cache entry holds (walking tuples and
    dataclasses of tensors; host numpy arrays and scalars count 0)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_nbytes(x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def _default_exec_cache_bytes(device: torch.device) -> int:
    """A quarter of the card's memory on CUDA; 4 GiB of host memory on
    the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return 4 * 2**30


def _value_digest(h: HostCSR) -> str:
    """Cheap digest of a matrix's numeric values (pattern excluded)."""
    d = hashlib.blake2b(digest_size=8)
    d.update(np.ascontiguousarray(h.data, dtype=np.float32).tobytes())
    return d.hexdigest()


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


def _apply_plan_perm(a: HostCSR, plan: Plan, *, symmetric: bool) -> HostCSR:
    if plan.perm is None:
        return a
    if symmetric and a.nrows == a.ncols:
        return a.permute_symmetric(plan.perm)
    return a.permute_rows(plan.perm)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


class Planner:
    """Feature-driven plan selection with a fingerprint-keyed cache.

    Args:
      cache: a :class:`PlanCache` (defaults to in-memory only).
      cost_model: shared :class:`CostModel` (default: one for ``device``);
        measurements accumulate here.
      measurer: ``(a, candidate[, workload]) -> Measurement`` used by
        measured mode; defaults to timing the candidate on ``device``.
      measure_top / measure_budget: how many shortlisted candidates
        measured mode probes, and the cap on their summed predicted
        preprocessing (in SpGEMM-equivalents).
      calibration: optional fitted
        :class:`~repro_torch.planner.calibration.Calibration` forwarded
        into a default-constructed cost model (ignored when
        ``cost_model`` is given — configure that instance directly).
      pallas_b_dtype: dtype the pallas scheme packs B's live tiles in
        (``None``: float32; ``torch.bfloat16`` halves B's bytes at the
        documented 2e-2 relative bound, fp32 accumulation either way).
      auditor: drift auditor executed plans are recorded into.
      probe_timeout_s: per-candidate wall-clock cap on measured-mode
        probes (``None`` disables it).
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
                 measurer: Optional[Callable[..., Measurement]] = None,
                 measure_top: int = 4,
                 measure_budget: float = 1.3,
                 candidates: Sequence[Candidate] = DEFAULT_CANDIDATES,
                 calibration=None,
                 pallas_b_dtype: Optional[torch.dtype] = None,
                 auditor: Optional[obs_audit.DriftAuditor] = None,
                 probe_timeout_s: Optional[float] = 30.0,
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
        self.measurer = measurer if measurer is not None else self._measure
        self.measure_top = measure_top
        self.measure_budget = measure_budget
        self.candidates = tuple(candidates)
        self._resilience = resilience
        self.probe_timeout_s = probe_timeout_s
        self.hint_provider = hint_provider
        self.probe_skips = 0
        # (fingerprint, candidate.key) -> materialization artifacts, so a
        # measured candidate's preprocessing is never run twice
        self._artifacts: dict[tuple[str, str], tuple] = {}
        # fingerprint -> {reorder: (matrix, perm)} shared across one
        # planning pass's probes (dropped with the artifacts)
        self._reorders: dict[str, dict] = {}
        # (plan key, value digest) -> (packed device operands for
        # execute(), their tensor bytes), capped by entry count and by the
        # bytes held (fresh-valued traffic adds an entry per request);
        # oldest entries go first, an entry over the byte cap is not kept
        self._exec_cache: dict[str, tuple[tuple, int]] = {}
        self._exec_cache_cap = 64
        self._exec_cache_bytes_cap = _default_exec_cache_bytes(self.device)
        # the front-end's worker threads share one planner: this lock
        # guards the exec cache and the measured-mode artifacts (the plan
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
        fp = fingerprint(a)
        if reuse_hint is None:
            reuse_hint = (self.hint_provider(fp)
                          if self.hint_provider is not None else 1)
        with get_tracer().span("plan", workload=workload,
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
                        m = self._call_measurer(a, cand_p, workload)
                    except ProbeTimeoutError:
                        # skip-and-score-heuristically: a pathological
                        # candidate must not wedge the request
                        self._note_probe_skip()
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

    def _call_measurer(self, a: HostCSR, cand: Candidate,
                       workload: str) -> Measurement:
        """Invoke the (possibly injected) measurer, passing ``workload``
        only when its signature takes one."""
        if getattr(self.measurer, "__func__", None) is Planner._measure:
            return self._measure(a, cand, workload=workload)
        try:
            takes_workload = "workload" in inspect.signature(
                self.measurer).parameters
        except (TypeError, ValueError):
            takes_workload = False
        if takes_workload:
            return self.measurer(a, cand, workload=workload)
        return self.measurer(a, cand)

    def _probe_first(self, s: ScoredCandidate) -> bool:
        """An unmeasured kernel-tier candidate on the card. Its prior, the
        JAX package's traffic model, charges whole tiles where the card's
        kernels read only live columns, and ranks them far behind the
        gather tier; measured mode probes it first and lets the
        measurement decide."""
        return (self.device.type == "cuda" and not s.measured
                and s.candidate.scheme == "pallas")

    def _shortlist(self, ranked: list[ScoredCandidate]
                   ) -> list[ScoredCandidate]:
        """Identity (the baseline anchor) + the candidates worth probing.

        Two gates keep probing cheap: non-amortizing candidates are never
        measured (the break-even rule) — except the kernel tier on the
        card, whose prior overprices it and which goes first — and the
        cumulative *predicted* preprocessing of the shortlist is capped
        at ``measure_budget`` SpGEMM-equivalents.
        """
        out = [s for s in ranked if s.candidate.key == IDENTITY.key]
        spent = 0.0
        for s in sorted(ranked, key=lambda s: not self._probe_first(s)):
            if len(out) >= self.measure_top:
                break
            if s.candidate.key == IDENTITY.key:
                continue
            if not (s.amortizes or self._probe_first(s)):
                continue
            if spent + s.preprocess_rel > self.measure_budget:
                continue
            spent += s.preprocess_rel
            out.append(s)
        return out

    # -- direct measurement (default measurer) -------------------------------

    def _measure(self, a: HostCSR, cand: Candidate, *,
                 reps: int = 2, workload: str = "a2") -> Measurement:
        """Time preprocessing + one-call execution of ``cand`` on ``a``,
        device-synced. Past ``probe_timeout_s`` with no timed rep yet,
        :class:`ProbeTimeoutError` tells the planning loop to skip the
        candidate; with one rep banked the measurement is cut short."""
        t_start = time.perf_counter()
        cap = self.probe_timeout_s

        def _over() -> float | None:
            if cap is None:
                return None
            el = time.perf_counter() - t_start
            return el if el > cap else None

        fp = fingerprint(a)
        fp_w = fp if workload == "a2" else f"{fp}|{workload}"
        with self._state_lock:
            rcache = self._reorders.setdefault(fp, {})
        perm, boundaries, max_cluster, t_pre = _materialize(
            a, cand, reorder_cache=rcache)
        with self._state_lock:
            self._artifacts[(fp_w, cand.key)] = (perm, boundaries,
                                                 max_cluster, t_pre)
        el = _over()
        if el is not None:
            raise ProbeTimeoutError(cand.key, el, cap)
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
        el = _over()
        if el is not None:
            raise ProbeTimeoutError(cand.key, el, cap)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            runner()
            best = min(best, time.perf_counter() - t0)
            if _over() is not None:
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
        key = policy.triple(plan.fingerprint, plan.scheme, plan.reorder)
        try:
            out = self._guarded_execute(plan, a, b)
        except Exception as e:           # noqa: BLE001 — ladder catches all
            primary = e                  # outlives the except block
            policy.breaker.record_failure(key)
        else:
            policy.breaker.record_success(key)
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
        key = policy.triple(plan.fingerprint, plan.scheme, plan.reorder)
        try:
            out = self._guarded_execute(plan, a, b)
        except Exception as e:           # noqa: BLE001 — batcher disbands
            policy.breaker.record_failure(key)
            policy.record_incident(
                fingerprint=plan.fingerprint, workload=plan.workload,
                scheme=plan.scheme, reorder=plan.reorder,
                site=self._classify_failure(e), error=e,
                fallback="unbatch")
            obs_metrics.get_registry().counter(
                "serve_fallbacks", scheme=plan.scheme).inc()
            raise
        policy.breaker.record_success(key)
        return out

    def _run_ladder(self, plan: Plan, a: HostCSR,
                    b: HostCSR | np.ndarray | None,
                    primary: Exception) -> np.ndarray:
        """Walk the fallback rungs below ``plan.scheme`` after ``primary``
        failed; records the incident and the ``serve_fallbacks`` metric
        on the rung that recovers the request."""
        policy = self.resilience
        tracer = get_tracer()
        site = self._classify_failure(primary)
        causes: list[tuple[str, Exception]] = [(plan.scheme, primary)]
        for rung in fallback_chain(plan.scheme):
            fb = self._fallback_plan(plan, rung, a)
            with tracer.span("fallback", fingerprint=plan.fingerprint,
                             from_scheme=plan.scheme, to_scheme=rung,
                             site=site) as sp:
                try:
                    if rung == "rowwise":
                        # the identity rung is the guaranteed-safe floor:
                        # under the fault harness it runs fault-suppressed
                        with _faults.suppressed():
                            out = self._guarded_execute(fb, a, b)
                    else:
                        out = self._guarded_execute(fb, a, b)
                except Exception as e:   # noqa: BLE001 — ladder walks on
                    causes.append((rung, e))
                    sp.set(recovered=False)
                    continue
                sp.set(recovered=True)
            policy.record_incident(
                fingerprint=plan.fingerprint, workload=plan.workload,
                scheme=plan.scheme, reorder=plan.reorder, site=site,
                error=primary, fallback=rung)
            obs_metrics.get_registry().counter(
                "serve_fallbacks", scheme=plan.scheme).inc()
            return out
        policy.record_incident(
            fingerprint=plan.fingerprint, workload=plan.workload,
            scheme=plan.scheme, reorder=plan.reorder, site=site,
            error=primary, fallback="")
        raise LadderExhaustedError(plan.scheme, causes) from primary

    def _guarded_execute(self, plan: Plan, a: HostCSR,
                         b: HostCSR | np.ndarray | None) -> np.ndarray:
        """One execution under the output guard: the fault harness's
        ``output`` site corrupts here, and a non-finite result raises (one
        float64 sum on the host)."""
        out = self._execute_impl(plan, a, b)
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
        policy = self.resilience
        if plan.scheme == "pallas":
            try:
                host = self._chain_hop_sparse(plan, cur, b)
            except Exception as e:       # noqa: BLE001 — ladder catches all
                if not policy.ladder:
                    raise
                policy.breaker.record_failure(policy.triple(
                    plan.fingerprint, plan.scheme, plan.reorder))
                policy.record_incident(
                    fingerprint=plan.fingerprint, workload=plan.workload,
                    scheme=plan.scheme, reorder=plan.reorder,
                    site=self._classify_failure(e), error=e,
                    fallback="dense_route")
                obs_metrics.get_registry().counter(
                    "serve_fallbacks", scheme=plan.scheme).inc()
                host = None
            if host is not None:
                return host
        dense = self.execute(plan, cur, b)
        return HostCSR.from_dense(dense)

    def _chain_hop_sparse(self, plan: Plan, cur: HostCSR,
                          b: Optional[HostCSR]) -> Optional[HostCSR]:
        """The sparse-C route of a pallas chain hop, or ``None`` when the
        live-pair grid does not apply (wide B: the dense :meth:`execute`
        path runs the padded grid instead). The pack is exec-cached, under
        the cache's byte cap, like the dense paths'."""
        bh_cols = (cur if b is None else b).ncols
        if not kernel_ops.compact_grid_ok_ncols(bh_cols):
            return None
        dev = self.device
        vk = (_value_digest(cur) if b is None else
              f"{_value_digest(cur)}|{fingerprint(b)}|{_value_digest(b)}")
        ck = (f"{plan.fingerprint}|{_plan_digest(plan)}|chain"
              f"|{'sq' if b is None else 'ab'}|{vk}")
        tracer = get_tracer()
        cached = self._exec_get(ck)
        if cached is None:
            with tracer.span("pack", fingerprint=plan.fingerprint,
                             scheme=plan.scheme, kind="sparse_c"):
                _faults.maybe_fault("pack")
                ap = _apply_plan_perm(cur, plan, symmetric=b is None)
                bh = ap if b is None else b
                bk = select_block_k(bh)
                bcc = bcc_from_host(ap, block_k=bk, device=dev)
                tiled = tiled_csr_from_host(bh, block_k=bk,
                                            dtype=self.pallas_b_dtype,
                                            device=dev)
                if not kernel_ops.compact_grid_ok(bcc, tiled):
                    return None
                cached = ("chain", tiled,
                          kernel_ops.pack_spgemm(bcc, tiled, sparse_c=True))
                self._exec_put(ck, cached)
            self._note_pack()
        _, tiled, pack = cached
        with tracer.span("kernel", scheme=plan.scheme, variant="sparse_c"):
            t0 = time.perf_counter()
            cc = kernel_ops.bcc_spgemm_sparse_c(None, tiled, pack=pack)
            synchronize(dev)
            kernel_s = time.perf_counter() - t0
        self.auditor.record(plan, kernel_s)
        host = compacted_c_to_host(cc)
        if plan.perm is not None:
            inv = np.argsort(np.asarray(plan.perm, dtype=np.int64))
            host = (host.permute_symmetric(inv) if b is None
                    else host.permute_rows(inv))
        return host

    def _build_runner(self, plan: Plan, a: HostCSR,
                      b: HostCSR | np.ndarray | None):
        dense_b = isinstance(b, np.ndarray) or (
            b is not None and not isinstance(b, HostCSR))
        squared = b is None
        if squared and a.nrows != a.ncols:
            raise ValueError("A² workload needs a square matrix")
        dev = self.device
        # the plan fingerprint is value-independent; the packed operands
        # are not — key them by the operand values (and for a second
        # sparse operand, its pattern too) AND by the plan's layout
        vk = _value_digest(a) if squared or dense_b \
            else f"{_value_digest(a)}|{fingerprint(b)}|{_value_digest(b)}"
        ck = f"{plan.fingerprint}|{_plan_digest(plan)}" \
             f"|{'sq' if squared else 'ab'}" \
             f"|{'dense' if dense_b else 'csr'}|{vk}"
        cached = self._exec_get(ck)
        perm = plan.perm

        if dense_b:
            bd = torch.from_numpy(np.ascontiguousarray(
                b, dtype=np.float32)).to(dev)
            if cached is None:
                with get_tracer().span("pack", fingerprint=plan.fingerprint,
                                       scheme=plan.scheme, kind="dense_b"):
                    _faults.maybe_fault("pack")
                    ap = _apply_plan_perm(a, plan, symmetric=False)
                    if plan.scheme == "rowwise":
                        cached = ("spmm_row", csr_from_host(ap, device=dev))
                    elif plan.scheme == "pallas":
                        # keep the compact stream and its slabs' live
                        # columns only: the launch reads nothing else of
                        # the padded BCC
                        stream = kernel_ops.bcc_compact_stream(
                            bcc_from_host(ap, device=dev),
                            cover_all_blocks=True)
                        cached = ("spmm_pallas", ap.nrows, stream,
                                  kernel_ops.slab_columns(stream[2]))
                    else:
                        cc = csr_cluster_from_host(
                            ap, self._bounds(plan, ap),
                            max_cluster=plan.max_cluster, device=dev)
                        cached = ("spmm_cluster", cc)
                    self._exec_put(ck, cached)
                self._note_pack()
            kind = cached[0]
            if kind == "spmm_row":
                op = cached[1]
                out = lambda: spmm_rowwise(op, bd)         # noqa: E731
            elif kind == "spmm_pallas":
                _, nrows, stream, cols = cached
                out = lambda: kernel_ops.spmm_compact_stream(  # noqa: E731
                    stream, bd, nrows=nrows, cols=cols)
            else:
                op = cached[1]
                out = lambda: spmm_clusterwise(op, bd)     # noqa: E731
            return self._unpermuted(out, perm, rows_only=True)

        if cached is None:
            with get_tracer().span("pack", fingerprint=plan.fingerprint,
                                   scheme=plan.scheme,
                                   kind="sq" if squared else "ab"):
                _faults.maybe_fault("pack")
                if squared:
                    ap = _apply_plan_perm(a, plan, symmetric=True)
                    bh = ap
                else:
                    ap = _apply_plan_perm(a, plan, symmetric=False)
                    bh = b
                if plan.scheme == "pallas":
                    # BCC(A) × TiledCSR(B) through the kernel tier: the
                    # adaptive k-tile height, the compact A stream, the
                    # route (live-pair grid, or the padded grid for wide
                    # B) and its device launch are packed once per cached
                    # operand pair — a cache hit goes straight to the
                    # kernel. The entry keeps B's tiles and the pack,
                    # which holds all the launch reads of A (not the
                    # padded BCC)
                    bk = select_block_k(bh)
                    tiled = tiled_csr_from_host(bh, block_k=bk,
                                                dtype=self.pallas_b_dtype,
                                                device=dev)
                    cached = ("pallas", tiled, kernel_ops.pack_spgemm(
                        bcc_from_host(ap, block_k=bk, device=dev), tiled))
                else:
                    dev_b = csr_from_host(bh, device=dev)
                    b_lens = bh.row_nnz()
                    if plan.scheme == "rowwise":
                        dev_a = csr_from_host(ap, device=dev)
                        fetch = np.zeros(dev_a.nnz_cap, dtype=np.int64)
                        fetch[: ap.nnz] = b_lens[
                            ap.indices.astype(np.int64)]
                        bins = length_bins(fetch,
                                           pad_sentinel=dev_a.nnz_cap)
                        srows = slot_rows_host(ap.indptr, dev_a.nnz_cap)
                        cached = ("row", dev_a, dev_b, bins, srows)
                    else:
                        bounds = self._bounds(plan, ap)
                        cc = csr_cluster_from_host(
                            ap, bounds, max_cluster=plan.max_cluster,
                            device=dev)
                        cptr = cc.cluster_ptr.cpu().numpy()
                        total = int(cptr[-1])
                        slot_cols = cc.cols.cpu().numpy()[:total].astype(
                            np.int64)
                        fetch = np.zeros(cc.slot_cap, dtype=np.int64)
                        fetch[:total] = np.where(
                            slot_cols < bh.nrows, b_lens[
                                np.clip(slot_cols, 0, bh.nrows - 1)], 0)
                        bins = length_bins(fetch, pad_sentinel=cc.slot_cap)
                        sclust = slot_rows_host(cptr, cc.slot_cap)
                        cached = ("cluster", cc, dev_b, bins, sclust)
                self._exec_put(ck, cached)
            self._note_pack()
        kind = cached[0]
        if kind == "pallas":
            _, tiled, pack = cached
            out = lambda: kernel_ops.bcc_spgemm_tiled(  # noqa: E731
                None, tiled, pack=pack)
        elif kind == "row":
            _, op_a, op_b, bins, srows = cached
            out = lambda: spgemm_rowwise_dense_binned(  # noqa: E731
                op_a, op_b, bins, srows)
        else:
            _, op_a, op_b, bins, sclust = cached
            out = lambda: spgemm_clusterwise_dense_binned(  # noqa: E731
                op_a, op_b, bins, sclust)
        return self._unpermuted(out, perm, rows_only=not squared)

    def _exec_get(self, key: str):
        """The packed operands kept under ``key``, or ``None``."""
        with self._state_lock:
            return self._exec_cache.get(key, (None, 0))[0]

    def _exec_put(self, key: str, packed: tuple) -> None:
        """Keep ``packed`` under ``key``, evicting the oldest entries until
        both caps hold; an entry over the byte cap alone is not kept."""
        nbytes = _tensor_nbytes(packed)
        if nbytes > self._exec_cache_bytes_cap:
            return
        with self._state_lock:
            while self._exec_cache and (
                    len(self._exec_cache) >= self._exec_cache_cap
                    or self._exec_nbytes_locked() + nbytes
                    > self._exec_cache_bytes_cap):
                self._exec_cache.pop(next(iter(self._exec_cache)))
            self._exec_cache[key] = (packed, nbytes)

    def _exec_nbytes_locked(self) -> int:
        return sum(n for _, n in self._exec_cache.values())

    def _exec_cache_nbytes(self) -> int:
        """Tensor bytes the exec cache holds now."""
        with self._state_lock:
            return self._exec_nbytes_locked()

    def _note_pack(self) -> None:
        """Account one exec-cache packing miss in the metrics registry."""
        reg = obs_metrics.get_registry()
        reg.counter("exec_cache_packs").inc()
        with self._state_lock:
            entries, nbytes = (len(self._exec_cache),
                               self._exec_nbytes_locked())
        reg.gauge("exec_cache_entries").set(entries)
        reg.gauge("exec_cache_bytes").set(nbytes)

    def _note_probe_skip(self) -> None:
        """Account one wall-clock-capped probe skip."""
        self.probe_skips += 1
        obs_metrics.get_registry().counter("probe_skips").inc()

    @staticmethod
    def _bounds(plan: Plan, ap: HostCSR) -> list[int]:
        if plan.boundaries is None:
            raise ValueError(f"plan scheme {plan.scheme} has no boundaries")
        return np.asarray(plan.boundaries, dtype=np.int64).tolist()

    def _unpermuted(self, run, perm: Optional[np.ndarray], *,
                    rows_only: bool):
        """Wrap a device runner: sync the card, copy the result to host
        numpy and undo the plan's permutation there."""
        dev = self.device

        def host() -> np.ndarray:
            out = run()
            synchronize(dev)
            # the padded grid returns B's dtype: bf16 widens to float32 on
            # the host, values equal to the JAX package's bfloat16 result
            # (numpy has no bfloat16, and ml_dtypes is not a dependency;
            # the README's port section records this divergence)
            return out.cpu().float().numpy()

        if perm is None:
            return host
        p = np.asarray(perm, dtype=np.int64)

        def wrapped() -> np.ndarray:
            cp = host()
            out = np.empty_like(cp)
            if rows_only:
                out[p] = cp
            else:
                out[np.ix_(p, p)] = cp
            return out
        return wrapped

    @property
    def stats(self) -> dict:
        with self._state_lock:
            entries, nbytes = (len(self._exec_cache),
                               self._exec_nbytes_locked())
        return {**self.cache.stats, "exec_entries": entries,
                "exec_bytes": nbytes,
                "probe_skips": self.probe_skips,
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


def reset_default_planner() -> None:
    global _DEFAULT
    _DEFAULT = None


def plan_spgemm(a: HostCSR, reuse_hint: int = 1, *,
                measure: bool = False, **kwargs) -> Plan:
    """Plan an SpGEMM on ``a`` expected to be reused ``reuse_hint`` times."""
    return default_planner().plan(a, reuse_hint, measure=measure, **kwargs)


def execute(plan: Plan, a: HostCSR,
            b: HostCSR | np.ndarray | None = None) -> np.ndarray:
    """Execute a planned product (see :meth:`Planner.execute`)."""
    return default_planner().execute(plan, a, b)


def execute_chain(a: HostCSR, *, hops: int = 2,
                  **kwargs) -> tuple[HostCSR, list]:
    """Chained product ``A^(hops+1)`` via the default planner (see
    :meth:`Planner.execute_chain`)."""
    return default_planner().execute_chain(a, hops=hops, **kwargs)
