"""One client in a closed loop of A·B requests to ``SpGEMMServer.submit``.

Request ``k`` multiplies pool matrix ``k mod len(pool)`` by dense B
number ``k mod b_count``: n × ``b_cols`` matrices of the configuration's
``dtype`` with entries drawn from ``b_values``, made in set-up. Set-up
plans and packs every matrix of the pool (each one's first request is a
cold plan) and serves ``warm_requests`` requests in all; the window then
sends the next request as soon as the last one's result is on the host.

With ``fresh_values`` every request's A keeps its pattern and takes new
values, drawn from the configuration's ``values`` by a generator seeded
with the run's seed and the request's number, as a graph attention layer
re-weights its edges on every pass: each request's plan hits and its
packed operands miss. The draw is the client's work, inside the window
and outside the request's latency.

Mix keys: ``b_cols``, ``b_count``, ``b_values``, ``reuse_hint`` (the
server's ``default_reuse_hint``), ``warm_requests``, ``fresh_values``
(optional, default false), ``checked`` (how many answers of the window
are kept, by a seeded uniform sample, and compared with the reference
after it).
"""
from __future__ import annotations

import sys
import time

import numpy as np

from cardbench import graphs, harness, reference, roofline

__all__ = ["Traffic"]


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int, system):
        self.config, self.mix, self.seed, self.system = (config, mix, seed,
                                                         system)
        self.fresh = bool(mix.get("fresh_values", False))

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.pool = [a for group in harness.pool(self.config, self.seed)
                     for a in group]
        self.ops = [self.system.operand(a) for a in self.pool]
        rng = np.random.default_rng([self.seed, 1])
        vals = np.asarray(self.mix["b_values"], dtype=self.config["dtype"])
        n = self.pool[0].n
        self.bs = [rng.choice(vals, size=(n, int(self.mix["b_cols"])))
                   for _ in range(int(self.mix["b_count"]))]
        self.least = [roofline.least_s(*roofline.spmm_work(
            a.n, a.nnz, int(self.mix["b_cols"]))) for a in self.pool]
        self.server = self.system.server(
            default_reuse_hint=int(self.mix["reuse_hint"]), measure=False)
        self.sample = harness.Reservoir(self.mix["checked"], self.seed)
        t1 = time.perf_counter()
        cold = []
        for k in range(len(self.ops)):
            self._request(k, self._operand(k))
            cold.append(time.perf_counter() - t1 - sum(cold))
        t2 = time.perf_counter()
        for k in range(len(self.ops), int(self.mix["warm_requests"])):
            self._request(k, self._operand(k))
        self.first = max(len(self.ops), int(self.mix["warm_requests"]))
        print(f"cardbench: inputs {t1 - t0:.3f} s ({len(self.pool)} x "
              f"{n} rows, {sum(a.nnz for a in self.pool)} entries), cold "
              f"requests {', '.join(f'{c:.3f}' for c in cold)} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def _pair(self, k: int) -> tuple[int, int]:
        return k % len(self.ops), k % len(self.bs)

    def _matrix(self, k: int) -> graphs.Csr:
        """Request ``k``'s A as the benchmark's own arrays."""
        a = self.pool[self._pair(k)[0]]
        if not self.fresh:
            return a
        rng = np.random.default_rng([self.seed, 2, k])
        return graphs.integer_values(a, rng, self.config["values"],
                                     self.config["dtype"])

    def _operand(self, k: int):
        if not self.fresh:
            return self.ops[self._pair(k)[0]]
        return self.system.operand(self._matrix(k))

    def _request(self, k: int, op):
        return self.server.submit(op, self.bs[self._pair(k)[1]]).result

    def run(self, window: harness.Window) -> None:
        k = self.first
        while window.running():
            g = self._pair(k)[0]
            op = self._operand(k)
            window.submitted()
            t0 = time.perf_counter()
            try:
                out = self._request(k, op)
            except Exception:   # noqa: BLE001 — a failed request is counted
                window.fail()
            else:
                window.served(t0, time.perf_counter(), self.least[g])
                slot = self.sample.slot()
                if slot is not None:
                    self.sample.put(slot, (k, out))
            window.boundary()
            k += 1

    def batching(self):
        return None

    def release(self) -> None:
        self.server = None

    def check(self) -> dict:
        """The largest gap between a sampled answer and the reference
        (infinite when no answer was sampled)."""
        want, err = {}, 0.0 if self.sample.items else float("inf")
        for k, out in sorted(self.sample.items, key=lambda item: item[0]):
            g, j = self._pair(k)
            key = (k,) if self.fresh else (g, j)
            if key not in want:
                want[key] = reference.product(self._matrix(k), self.bs[j])
            err = max(err, reference.max_abs_err(out, want[key]))
            if self.fresh:
                del want[key]
        return {"max_abs_err": [err, 0.0]}
