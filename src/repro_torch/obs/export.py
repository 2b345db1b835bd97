"""Chrome-trace / Perfetto JSON export of the recorded spans + metrics.

``export_chrome_trace(path)`` writes one JSON document loadable in
``chrome://tracing`` / https://ui.perfetto.dev:

- ``"complete"`` spans -> ``ph: "X"`` complete events (``ts``/``dur`` in
  microseconds relative to the tracer epoch), with span attributes under
  ``args`` — the nested compiler timeline renders directly from these.
- ``"async"`` spans (per-request serving lifecycles that overlap
  arbitrarily) -> paired ``ph: "b"``/``"e"`` async events keyed by span
  id, so concurrent requests stack in their own track rather than
  fighting for the thread's synchronous lane.
- ``"instant"`` spans -> ``ph: "i"`` thread-scoped instants.
- one ``ph: "M"`` thread-name metadata record per recording thread.

The metrics snapshot rides along under ``otherData.metrics`` so a single
file carries the full run: open it in the trace viewer, or feed it to
``python -m repro_torch.obs trace.json`` for a terminal summary.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import Span, Tracer

_PID = 1  # single-process trace; chrome://tracing wants some pid


def _args(span: Span) -> Dict[str, Any]:
    args = {k: v for k, v in span.attrs.items()}
    if span.parent_id is not None:
        args["parent_span"] = span.parent_id
    return args


def chrome_trace_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """Convert the tracer's finished spans to Chrome-trace events."""
    epoch = tracer.epoch
    events: List[Dict[str, Any]] = []
    threads: Dict[int, str] = {}
    for span in tracer.spans():
        threads.setdefault(span.tid, span.thread)
        ts = round((span.t0 - epoch) * 1e6, 3)
        base = {"name": span.name, "cat": span.cat or "repro_torch",
                "pid": _PID, "tid": span.tid, "ts": ts, "args": _args(span)}
        if span.kind == "async":
            ident = str(span.attrs.get("rid", span.span_id))
            events.append({**base, "ph": "b", "id": ident})
            events.append({**base, "ph": "e", "id": ident,
                           "ts": round((span.t1 - epoch) * 1e6, 3),
                           "args": {}})
        elif span.kind == "instant":
            events.append({**base, "ph": "i", "s": "t"})
        else:
            events.append({**base, "ph": "X",
                           "dur": round(span.dur_s * 1e6, 3)})
    for tid, name in sorted(threads.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                       "tid": tid, "args": {"name": name or f"thread-{tid}"}})
    return events


def chrome_trace(tracer: Tracer,
                 metrics_snapshot: Optional[Dict[str, Any]] = None,
                 ) -> Dict[str, Any]:
    """The full trace document: events plus metadata."""
    doc: Dict[str, Any] = {
        "traceEvents": chrome_trace_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": {"source": "repro_torch.obs",
                      "dropped_spans": tracer.dropped},
    }
    if metrics_snapshot is not None:
        doc["otherData"]["metrics"] = metrics_snapshot
    return doc


def export_chrome_trace(path, tracer: Tracer,
                        metrics_snapshot: Optional[Dict[str, Any]] = None,
                        ) -> pathlib.Path:
    """Write the Chrome-trace JSON to ``path`` and return it."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = chrome_trace(tracer, metrics_snapshot)
    path.write_text(json.dumps(doc, indent=1, sort_keys=True, default=str))
    return path
