"""Serving: the compiled-Design request engine and the queue and latency
bookkeeping shared by the serving paths.

:class:`DesignEngine` — async adaptive batching over a compiled
:class:`repro_torch.hls.Design`, each bucket a captured CUDA graph on the
card, with warm-boot restarts (``repro_torch.hls.load``) and
fault-tolerant request re-queuing.
"""

from repro_torch.serving.common import (DropOldestRing, QueuedRequest,
                                        RequestQueue, percentiles)
from repro_torch.serving.design_engine import (DesignEngine, EngineReport,
                                               default_buckets)

__all__ = [
    "DesignEngine",
    "DropOldestRing",
    "EngineReport",
    "QueuedRequest",
    "RequestQueue",
    "default_buckets",
    "percentiles",
]
