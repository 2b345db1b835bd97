"""Serving engines: LM continuous batching and the compiled-Design request
engine, over one set of queue/latency helpers
(:mod:`repro_torch.serving.common`).

- :class:`ServingEngine` — lane-based continuous batching for LM decode.
- :class:`DesignEngine` — async adaptive batching over a compiled
  :class:`repro_torch.hls.Design`, each bucket a captured CUDA graph on the
  card, with warm-boot restarts (``repro_torch.hls.load``) and
  fault-tolerant request re-queuing.
"""

from repro_torch.serving.common import (DropOldestRing, QueuedRequest,
                                        RequestQueue, percentiles)
from repro_torch.serving.design_engine import (DesignEngine, EngineReport,
                                               default_buckets)
from repro_torch.serving.engine import Request, ServingEngine

__all__ = [
    "DesignEngine",
    "DropOldestRing",
    "EngineReport",
    "QueuedRequest",
    "Request",
    "RequestQueue",
    "ServingEngine",
    "default_buckets",
    "percentiles",
]
