"""The system under test: the port's servers, as the traffic sees them.

The traffic talks to a system through four calls: ``operand`` (the
benchmark's CSR in the program's type), ``server`` (a synchronous
``SpGEMMServer``), ``async_server`` (an ``AsyncSpGEMMServer`` over one)
and, for the readers, ``tracer`` and ``counters``. ``control.Control``
offers the same calls with the reference in the program's place.
"""
from __future__ import annotations

__all__ = ["Program"]


class Program:
    """The port (``repro_torch``) on ``device``."""

    def __init__(self, device: str):
        self.device = device

    def operand(self, a):
        from repro_torch.core.formats import HostCSR
        return HostCSR(a.indptr, a.indices, a.data, (a.n, a.n))

    def server(self, **kwargs):
        """A ``SpGEMMServer`` with its own in-memory plan cache (never
        the disk tier of ``default_planner()``)."""
        from repro_torch.serve.engine import SpGEMMServer
        return SpGEMMServer(device=self.device, **kwargs)

    def async_server(self, **kwargs):
        from repro_torch.serve.frontend import AsyncSpGEMMServer
        return AsyncSpGEMMServer(self.server(), **kwargs)

    def tracer(self):
        from repro_torch.obs.trace import get_tracer
        return get_tracer()

    def counters(self) -> dict:
        """The program's metrics registry, as a snapshot."""
        from repro_torch.obs.metrics import get_registry
        return get_registry().snapshot()
