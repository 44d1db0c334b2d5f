"""Serving entry points: the planner-routed ``SpGEMMServer`` and the
async front-end over it (``AsyncSpGEMMServer``: bounded admission,
deadlines, coalescing, watermark downgrades, live reuse hints and
cross-request batching)."""
from repro_torch.serve.batcher import (BATCH_METRICS, BatchPolicy, Batcher,
                                       batchable, compatible)
from repro_torch.serve.engine import SpGEMMResponse, SpGEMMServer
from repro_torch.serve.estimator import ReuseEstimator
from repro_torch.serve.frontend import AsyncSpGEMMServer
from repro_torch.serve.queue import (BoundedRequestQueue, QueuedRequest,
                                     Ticket)

__all__ = ["AsyncSpGEMMServer", "BATCH_METRICS", "BatchPolicy", "Batcher",
           "BoundedRequestQueue", "QueuedRequest", "ReuseEstimator",
           "SpGEMMResponse", "SpGEMMServer", "Ticket", "batchable",
           "compatible"]
