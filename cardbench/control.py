"""The control: the reference, in bfloat16, put in the program's place.

The configurations serve float32 and promise exact answers on integer
values; bfloat16 is the precision one step below. Run in the program's
place through a cell's own traffic and comparison, the control has to
come out not correct, which shows the comparison can fail:

    python3 cardbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5

prints one JSON line per seed with the compared numbers. The benchmark's
own runs never run it.
"""
import argparse
import json
import os
import sys
import time
import types

if __name__ == "__main__":
    sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))]

from cardbench import reference  # noqa: E402

__all__ = ["Control"]


class _Ticket:
    def __init__(self, response):
        self._response = response

    def result(self, timeout=None):
        return self._response


class _Server:
    def __init__(self, device):
        self.device = device

    def submit(self, a, b=None, **_):
        return types.SimpleNamespace(
            result=reference.control_product(a, b, self.device))

    def stats(self):
        return {}

    def close(self):
        pass


class _AsyncServer(_Server):
    def submit(self, a, b=None, **kwargs):
        return _Ticket(super().submit(a, b))


class Control:
    """The system interface of ``cardbench.system.Program``, served by
    ``reference.control_product`` on ``device``."""

    def __init__(self, device: str):
        self.device = device

    def operand(self, a):
        return a

    def server(self, **_):
        return _Server(self.device)

    def async_server(self, **_):
        return _AsyncServer(self.device)

    def tracer(self):
        return None

    def counters(self) -> dict:
        return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from cardbench import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False,
                          device=args.device, t_start=t0,
                          system=Control(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": {k: [str(v), lim] for k, (v, lim)
                                     in res["checks"].items()},
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
