"""repro_torch.obs — unified tracing, metrics, and profiling for compile + serve.

One process-wide :class:`~repro_torch.obs.trace.Tracer` and one
:class:`~repro_torch.obs.metrics.MetricsRegistry`, shared by the compiler
(``CompilerDriver.compile`` and every pass round), the pallas emission
backend (per-kernel timings, plan counters), the serving stack
(``DesignEngine`` request lifecycle, queue-depth histogram), and the
hard-real-time trigger (one ``trigger.window`` span per dispatched
window; ``trigger.deadline_misses`` / ``trigger.dropped_frames`` /
``trigger.accepts`` / ``trigger.rejects`` counters).

Disabled by default: every helper here checks one module flag and
returns a shared no-op before touching the clock, so library users pay
nothing.  Enable with :func:`enable` or ``REPRO_OBS=1`` in the
environment; export the recorded run with :func:`export_chrome_trace`
(opens in ``chrome://tracing`` / Perfetto) and summarise it with
``python -m repro_torch.obs <trace.json>``.

    from repro_torch import obs
    obs.enable()
    with obs.span("compile", design="braggnn"):
        ...
    obs.inc("design_cache.misses")
    obs.observe("serve.queue_depth", depth)
    obs.export_chrome_trace("trace.json")
    print(obs.metrics.to_prometheus())
"""

from __future__ import annotations

import os
import pathlib
import time
from typing import Any, Dict, Optional

from repro_torch.obs.logs import get_logger, setup_logging
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP_SPAN, Span, Tracer
from repro_torch.obs import export as _export

__all__ = [
    "tracer", "metrics", "enable", "disable", "enabled", "reset",
    "span", "record_span", "event", "inc", "gauge", "observe",
    "snapshot", "export_chrome_trace", "chrome_trace",
    "get_logger", "setup_logging", "Tracer", "Span", "MetricsRegistry",
    "NOOP_SPAN",
]

#: process-wide singletons — instrumentation sites and exporters share
#: these; swap only in tests (prefer ``reset()``)
tracer = Tracer()
metrics = MetricsRegistry()

_enabled = False


def enable() -> None:
    """Turn recording on process-wide (spans + metrics)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Return to the no-op default."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all recorded spans and metrics (keeps the enabled flag)."""
    tracer.clear()
    metrics.clear()


# -- guarded fast-path helpers -------------------------------------------
# Each returns/does nothing after a single flag check when disabled; this
# is the contract that keeps instrumented hot paths near-free by default.

def span(name: str, cat: str = "", **attrs: Any):
    """``with obs.span("passes.cse", ops=n) as sp:`` — a nested span on
    the process tracer, or the shared no-op when disabled."""
    if not _enabled:
        return NOOP_SPAN
    return tracer.span(name, cat, **attrs)


def record_span(name: str, t0: float, t1: float, **kwargs: Any):
    """Retroactive span from explicit ``time.monotonic()`` bounds."""
    if not _enabled:
        return NOOP_SPAN
    return tracer.record(name, t0, t1, **kwargs)


def event(name: str, cat: str = "", **attrs: Any):
    if not _enabled:
        return NOOP_SPAN
    return tracer.event(name, cat, **attrs)


def inc(name: str, n: float = 1.0) -> None:
    if _enabled:
        metrics.inc(name, n)


def gauge(name: str, value: float) -> None:
    if _enabled:
        metrics.set_gauge(name, value)


def observe(name: str, value: float) -> None:
    if _enabled:
        metrics.observe(name, value)


def snapshot() -> Dict[str, Any]:
    """The metrics snapshot dict (always available, even when disabled —
    it is just empty then)."""
    return metrics.snapshot()


def chrome_trace() -> Dict[str, Any]:
    """The Chrome-trace document for the current recording."""
    return _export.chrome_trace(tracer, metrics.snapshot())


def export_chrome_trace(path) -> pathlib.Path:
    """Write spans + metrics as Chrome-trace JSON; returns the path."""
    return _export.export_chrome_trace(path, tracer, metrics.snapshot())


def now() -> float:
    """The tracer's clock (``time.monotonic``), for retroactive spans."""
    return time.monotonic()


if os.environ.get("REPRO_OBS", "").strip().lower() not in ("", "0", "false"):
    enable()
