"""Serving on the card: the LM serving step and engine, and
planner-driven SpGEMM serving.

``make_serve_step`` returns the one-token step of LM serving (greedy, or
sampled with an explicit :class:`torch.Generator`); ``launch/serve.py``
drives it after a prefill. ``ServingEngine`` is the host-side
continuous-batching loop over a fixed slot table, eager (no compiled
step) with the reference's semantics: each admitted prompt is replayed
token by token through ``decode_step``, one ``pos`` is shared by every
slot, and every decode step feeds token 0 to every slot.

``SpGEMMServer`` serves repeated sparse products: requests are (matrix,
operand, reuse hint) triples, and every pattern goes through the
planner, so the first request for a pattern pays feature extraction +
preprocessing once and every later request (same fingerprint, any
values) is a plan-cache hit straight into the packed kernel. Chain
requests (``hops=``) serve ``A^(hops+1)`` through the planner's chain
workload; a request the degradation ladder recovers reports
``degraded=True`` and the rung that served it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.formats import HostCSR
from repro_torch.models.transformer import (check_family, decode_step,
                                            init_cache)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import get_tracer
from repro_torch.planner.plan_cache import PlanCache
from repro_torch.planner.service import Planner
from repro_torch.resilience.errors import InvalidOperandError
from repro_torch.resilience.validation import validate_request_pair

__all__ = ["make_serve_step", "Request", "ServingEngine", "SpGEMMResponse",
           "SpGEMMServer"]


def make_serve_step(cfg, *, sample: bool = False,
                    temperature: float = 1.0) -> Callable:
    """Returns ``f(params, cache, batch, generator=None) -> (next_token,
    cache)``: one :func:`~repro_torch.models.transformer.decode_step`,
    then the argmax of the last logits — or, with ``sample``, of the
    logits over ``temperature`` plus Gumbel noise drawn from
    ``generator`` (a :class:`torch.Generator` on the logits' device)."""

    def serve_step(params, cache, batch, generator=None):
        logits, cache = decode_step(cfg, params, batch, cache)
        last = logits[:, -1]
        if not sample:
            return torch.argmax(last, dim=-1), cache
        if generator is None:
            raise ValueError("sampling needs an explicit generator")
        # -log(E) with E ~ Exp(1) is a standard Gumbel draw
        gumbel = -torch.log(torch.empty_like(last).exponential_(
            generator=generator))
        return torch.argmax(last / temperature + gumbel, dim=-1), cache

    return serve_step


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (len,) int token ids
    max_new_tokens: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Host-side continuous batching over a fixed slot table: the
    reference's engine, with its cache on the parameters' device and in
    their dtype."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None):
        check_family(cfg)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        norm = params["final_norm"]
        self.device = norm.device
        self.cache = init_cache(cfg, slots, max_len, dtype=norm.dtype,
                                device=norm.device)
        self.requests: list[Optional[Request]] = [None] * slots
        self.positions = np.zeros(slots, np.int64)
        self._step = make_serve_step(cfg)
        self._queue: list[Request] = []

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _tokens(self) -> torch.Tensor:
        return torch.zeros((self.slots, 1), dtype=torch.long,
                           device=self.device)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.requests[i] is None and self._queue:
                req = self._queue.pop(0)
                self.requests[i] = req
                # replay the prompt into this slot, one token a step (the
                # other slots see token 0)
                for t in req.prompt:
                    tok = self._tokens()
                    tok[i, 0] = int(t)
                    _, self.cache = decode_step(self.cfg, self.params,
                                                {"tokens": tok}, self.cache)
                self.positions[i] = len(req.prompt)

    def run(self, steps: int) -> None:
        """Up to ``steps`` decode steps, admitting queued requests into
        free slots before the first and after each. One ``pos`` is shared
        by every slot, as in the reference."""
        self._admit()
        for _ in range(steps):
            live = [i for i, r in enumerate(self.requests) if r is not None]
            if not live:
                return
            next_tok, self.cache = self._step(self.params, self.cache,
                                              {"tokens": self._tokens()})
            nt = next_tok.cpu().numpy()
            for i in live:
                req = self.requests[i]
                req.out.append(int(nt[i]))
                if (self.eos_id is not None and nt[i] == self.eos_id) \
                        or len(req.out) >= req.max_new_tokens:
                    req.done = True
                    self.requests[i] = None
            self._admit()


@dataclasses.dataclass
class SpGEMMResponse:
    result: "np.ndarray | HostCSR"  # dense C, original order (HostCSR for
    #                                 chain requests: sparse C)
    fingerprint: str
    reorder: str
    scheme: str
    workload: str              # a2 | spmm | chain — planned kernel family
    plan_cache_hit: bool
    plan_s: float              # planning + preprocessing wall time (0-ish on hit)
    execute_s: float           # packing (on a miss) + device-synced product
    trace_id: str = ""         # root span's trace id ("" when tracing is off)
    degraded: bool = False     # served by a degradation-ladder rung
    fallback_scheme: str = ""  # the rung that recovered it ("" when not)
    coalesced: bool = False    # shared an identical in-flight execution
    downgraded: bool = False   # the front-end forced the identity rung
    deadline_missed: bool = False  # completed past its deadline (counted)
    batched: bool = False      # served as one member of a block-diagonal
    batch_size: int = 0        # launch of this many distinct requests


class SpGEMMServer:
    """Serve repeated sparse products through the plan cache.

    One planner (one plan cache + one cost model) is shared across all
    requests; ``reuse_hint`` defaults to the server-level expectation of
    how often a pattern recurs (per-request override wins). Without an
    injected planner the server builds one on ``device`` (``"cuda"`` by
    default — it raises when there is no card) whose plan cache is
    namespaced to ``tenant``.
    """

    def __init__(self, planner: Optional[Planner] = None, *,
                 device="cuda", default_reuse_hint: int = 20,
                 measure: bool = False, tenant: str = ""):
        if planner is None:
            planner = Planner(cache=PlanCache(namespace=tenant),
                              device=device)
        self.planner = planner
        self.tenant = tenant
        self.default_reuse_hint = default_reuse_hint
        self.measure = measure
        self.requests = 0
        self.plan_hits = 0

    def submit(self, a: HostCSR, b: HostCSR | np.ndarray | None = None, *,
               reuse_hint: Optional[int] = None,
               hops: Optional[int] = None) -> SpGEMMResponse:
        """Plan (or fetch the cached plan for) ``a``, then execute a·b.

        A dense ``b`` routes the request through the planner's ``spmm``
        workload, cached apart from the same pattern's A² plan. ``hops``
        routes it through the ``chain`` workload instead (``b`` must be
        ``None``): ``result`` is the sparse :class:`HostCSR`
        ``A^(hops+1)``, the response reports the first hop's plan, and
        ``plan_cache_hit`` is true only when every hop hit the cache.

        With the resilience policy's validation on (the default),
        malformed operands — a non-monotone ``indptr``, out-of-range or
        unsorted indices, non-finite data, an inconsistent shape chain —
        are rejected here with a structured
        :class:`~repro_torch.resilience.errors.InvalidOperandError`
        (counted in ``serve_rejects`` by field); an operand object that
        passed once is not scanned again. A request whose execution
        failed and was recovered by the degradation ladder reports
        ``degraded=True`` and the recovering rung in ``fallback_scheme``.
        """
        self.requests += 1
        if reuse_hint is not None:
            hint: Optional[int] = reuse_hint
        elif self.planner.hint_provider is not None:
            hint = None
        else:
            hint = self.default_reuse_hint
        if hops is not None and b is not None:
            raise ValueError("chain requests take b=None (A^k workload)")
        workload = ("chain" if hops is not None
                    else "spmm" if (b is not None
                                    and not isinstance(b, HostCSR))
                    else "a2")
        reg = obs_metrics.get_registry()
        reg.counter("serve_requests", tenant=self.tenant).inc()
        policy = self.planner.resilience
        tracer = get_tracer()
        with tracer.span("request", tenant=self.tenant,
                         workload=workload) as root:
            if policy.validate:
                with tracer.span("validate"):
                    try:
                        validate_request_pair(a, b,
                                              skip=policy.is_validated)
                    except InvalidOperandError as e:
                        policy.rejects += 1
                        reg.counter("serve_rejects", tenant=self.tenant,
                                    field=e.field).inc()
                        raise
                    policy.mark_validated(a)
                    if b is not None and hasattr(b, "indptr"):
                        policy.mark_validated(b)
            resp = self._submit_impl(a, b, hint=hint, hops=hops,
                                     workload=workload)
            resp.trace_id = root.trace_id
            root.set(fingerprint=resp.fingerprint, scheme=resp.scheme,
                     cache_hit=resp.plan_cache_hit)
        reg.histogram("serve_request_s", tenant=self.tenant,
                      scheme=resp.scheme).observe(resp.plan_s
                                                  + resp.execute_s)
        reg.histogram("serve_plan_s", tenant=self.tenant).observe(resp.plan_s)
        reg.histogram("serve_execute_s",
                      tenant=self.tenant).observe(resp.execute_s)
        return resp

    def _submit_impl(self, a: HostCSR, b, *, hint: Optional[int],
                     hops: Optional[int], workload: str) -> SpGEMMResponse:
        """:meth:`submit` minus the span/metric bookkeeping. The timed
        execute region is device-synced: the planner's runners wait for
        the card before copying the result to the host."""
        policy = self.planner.resilience
        inc0 = policy.fallbacks
        if hops is not None:
            t0 = time.perf_counter()
            out, plans = self.planner.execute_chain(
                a, hops=hops, reuse_hint=hint, measure=self.measure)
            t1 = time.perf_counter()
            hit = all(p.from_cache for p in plans)
            if hit:
                self.plan_hits += 1
            lead = plans[0]
            degraded = policy.fallbacks > inc0
            # the chain's planning time: the per-hop planning wall times
            # execute_chain annotates on each plan
            plan_s = sum(getattr(p, "plan_wall_s", 0.0) for p in plans)
            return SpGEMMResponse(
                result=out, fingerprint=lead.fingerprint,
                reorder=lead.reorder, scheme=lead.scheme, workload="chain",
                plan_cache_hit=hit, plan_s=plan_s,
                execute_s=max(t1 - t0 - plan_s, 0.0), degraded=degraded,
                fallback_scheme=(policy.incidents[-1].fallback
                                 if degraded else ""))
        t0 = time.perf_counter()
        plan = self.planner.plan(a, hint, measure=self.measure,
                                 workload=workload)
        t1 = time.perf_counter()
        out = self.planner.execute(plan, a, b)
        t2 = time.perf_counter()
        if plan.from_cache:
            self.plan_hits += 1
        degraded = policy.fallbacks > inc0
        return SpGEMMResponse(
            result=out, fingerprint=plan.fingerprint, reorder=plan.reorder,
            scheme=plan.scheme, workload=workload,
            plan_cache_hit=plan.from_cache, plan_s=t1 - t0,
            execute_s=t2 - t1, degraded=degraded,
            fallback_scheme=(policy.incidents[-1].fallback
                             if degraded else ""))

    def stats(self) -> dict:
        """Serving snapshot: request/hit counts, the planner's cache
        partition, the drift auditor's rolling summary and the resilience
        policy's fallback/reject/quarantine accounting."""
        return {"requests": self.requests, "plan_hits": self.plan_hits,
                "tenant": self.tenant, **self.planner.stats,
                "plan_cache": dict(self.planner.cache.stats),
                "audit": self.planner.auditor.summary(),
                "resilience": self.planner.resilience.stats}
