"""One client in a closed loop of A² requests to ``SpGEMMServer.submit``.

Request ``k`` submits pool matrix ``k mod len(pool)`` with ``b=None``,
the same operand object every time it comes round, so the server's
validation memo, its plan cache and its executor cache all hit; the
server returns C = A·A dense, in A's order. Set-up plans and packs every
matrix of the pool (each one's first request is a cold plan) and serves
``warm_requests`` requests in all; the window then sends the next
request as soon as the last one's result is on the host.

Mix keys: ``reuse_hint`` (the server's ``default_reuse_hint``),
``warm_requests``, ``checked`` (how many answers of the window are kept,
by a seeded uniform sample, and compared with the reference after it;
each is a dense n × n answer on the host).
"""
from __future__ import annotations

import sys
import time

from cardbench import harness, reference, roofline

__all__ = ["Traffic"]


class Traffic:
    def __init__(self, config: dict, mix: dict, seed: int, system):
        self.config, self.mix, self.seed, self.system = (config, mix, seed,
                                                         system)

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.pool = [a for group in harness.pool(self.config, self.seed)
                     for a in group]
        self.ops = [self.system.operand(a) for a in self.pool]
        self.least = [roofline.least_s(*roofline.a2_work(a.indptr,
                                                         a.indices))
                      for a in self.pool]
        self.server = self.system.server(
            default_reuse_hint=int(self.mix["reuse_hint"]), measure=False)
        self.sample = harness.Reservoir(self.mix["checked"], self.seed)
        t1 = time.perf_counter()
        cold = []
        for k in range(len(self.ops)):
            self._request(k)
            cold.append(time.perf_counter() - t1 - sum(cold))
        t2 = time.perf_counter()
        for k in range(len(self.ops), int(self.mix["warm_requests"])):
            self._request(k)
        self.first = max(len(self.ops), int(self.mix["warm_requests"]))
        print(f"cardbench: inputs {t1 - t0:.3f} s ({len(self.pool)} x "
              f"{self.pool[0].n} rows, {sum(a.nnz for a in self.pool)} "
              f"entries), cold requests "
              f"{', '.join(f'{c:.3f}' for c in cold)} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def _request(self, k: int):
        return self.server.submit(self.ops[k % len(self.ops)]).result

    def run(self, window: harness.Window) -> None:
        k = self.first
        while window.running():
            window.submitted()
            t0 = time.perf_counter()
            try:
                out = self._request(k)
            except Exception:   # noqa: BLE001 — a failed request is counted
                window.fail()
            else:
                window.served(t0, time.perf_counter(),
                              self.least[k % len(self.ops)])
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
        (infinite when no answer was sampled); each pool matrix's A² is
        computed once."""
        want, err = {}, 0.0 if self.sample.items else float("inf")
        for k, out in sorted(self.sample.items, key=lambda item: item[0]):
            g = k % len(self.ops)
            if g not in want:
                want[g] = reference.product(self.pool[g])
            err = max(err, reference.max_abs_err(out, want[g]))
        return {"max_abs_err": [err, 0.0]}
