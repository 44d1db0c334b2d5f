"""One client in a closed loop of sparse A² requests to
``SpGEMMServer.submit(a, hops=1)``, C returned as CSR.

The loop of ``closed_square``: request ``k`` submits pool matrix ``k mod
len(pool)``, the same operand object every time it comes round, so the
server's validation memo, its plan cache and its executor cache all hit.
Here each request asks for one hop of the chain workload, whose answer
is C = A·A as the program's CSR (``indptr``, ``indices``, ``data``) in
A's order. Set-up plans and packs every matrix of the pool, serves
``warm_requests`` requests in all, and then computes each matrix's
float64 reference (``sparse_reference.product``), whose pattern gives
C's entries to the work of ``product_roofline``.

The check: each sampled answer's row pointers and column indices equal
the reference's, and its values differ from the reference's by at most
0 (``max_abs_err``; a difference in structure reads as infinite).

Run with the control (``cardbench/control.py``), whose server answers
dense n × n, the kind serves ``sparse_reference.control_product``
instead: the same product stored in bfloat16, as CSR.

Mix keys: those of ``closed_square``.
"""
from __future__ import annotations

import os
import sys
import time
import types

from cardbench import control, harness, roofline, sparse_reference

__all__ = ["Traffic"]

_base = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "closed_square.py"), "cardbench_traffic_closed_square")


class _SparseControlServer:
    def submit(self, a, b=None, **_):
        return types.SimpleNamespace(
            result=sparse_reference.control_product(a))


class _SparseControl(control.Control):
    """The control with its server answering as CSR."""

    def server(self, **_):
        return _SparseControlServer()


def _arrays(out) -> tuple:
    """An answer as ``(indptr, indices, data)``: the program's CSR, or
    the control's arrays."""
    if hasattr(out, "indptr"):
        return out.indptr, out.indices, out.data
    return tuple(out)


class Traffic(_base.Traffic):
    def __init__(self, config: dict, mix: dict, seed: int, system):
        # by name: cardbench/control.py runs as __main__, so its Control
        # is another class than this module's
        if type(system).__name__ == control.Control.__name__:
            system = _SparseControl(system.device)
        super().__init__(config, mix, seed, system)

    def setup(self) -> None:
        super().setup()
        t0 = time.perf_counter()
        self.want = [sparse_reference.product(a) for a in self.pool]
        self.least = [roofline.least_s(*sparse_reference.a2_csr_work(
            a, want[0][-1])) for a, want in zip(self.pool, self.want)]
        print(f"cardbench: reference {time.perf_counter() - t0:.3f} s "
              f"({', '.join(str(int(w[0][-1])) for w in self.want)} "
              f"entries of C)", file=sys.stderr)

    def _request(self, k: int):
        return _arrays(self.server.submit(self.ops[k % len(self.ops)],
                                          hops=1).result)

    def check(self) -> dict:
        """The largest gap between a sampled answer and the reference
        (infinite when no answer was sampled or a structure differs)."""
        err = 0.0 if self.sample.items else float("inf")
        for k, out in self.sample.items:
            err = max(err, sparse_reference.max_abs_err(
                out, self.want[k % len(self.ops)]))
        return {"max_abs_err": [err, 0.0]}
