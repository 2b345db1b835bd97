"""Terminal summary of an exported Chrome trace.

    PYTHONPATH=src python -m repro_torch.obs trace.json [--top 15]

Prints the top-k slowest complete spans, a per-name aggregate (count /
total / mean), reconstructed async request spans, and the metric table
embedded under ``otherData.metrics`` — the quick look before reaching
for chrome://tracing.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}us"


def _complete_spans(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    spans = [e for e in events if e.get("ph") == "X"]
    # async b/e pairs -> synthesised spans so requests show up too
    opens: Dict[Any, Dict[str, Any]] = {}
    for e in events:
        key = (e.get("name"), e.get("id"))
        if e.get("ph") == "b":
            opens[key] = e
        elif e.get("ph") == "e" and key in opens:
            b = opens.pop(key)
            spans.append({**b, "ph": "X",
                          "dur": e.get("ts", 0) - b.get("ts", 0)})
    return spans


def summarise(doc: Dict[str, Any], top: int = 15) -> str:
    events = doc.get("traceEvents", [])
    spans = _complete_spans(events)
    lines: List[str] = []

    lines.append(f"{len(events)} events, {len(spans)} spans")
    lines.append("")
    lines.append(f"slowest {min(top, len(spans))} spans:")
    for e in sorted(spans, key=lambda e: -e.get("dur", 0))[:top]:
        args = e.get("args") or {}
        attrs = ", ".join(f"{k}={v}" for k, v in sorted(args.items())
                          if k != "parent_span")
        lines.append(f"  {_fmt_us(e.get('dur', 0)):>10}  {e['name']}"
                     + (f"  [{attrs}]" if attrs else ""))

    agg: Dict[str, List[float]] = {}
    for e in spans:
        agg.setdefault(e["name"], []).append(e.get("dur", 0))
    lines.append("")
    lines.append("by span name (count / total / mean):")
    for name, durs in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
        lines.append(f"  {name:<28} {len(durs):>6}  "
                     f"{_fmt_us(sum(durs)):>10}  "
                     f"{_fmt_us(sum(durs) / len(durs)):>10}")

    snap = (doc.get("otherData") or {}).get("metrics") or {}
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    hists = snap.get("histograms") or {}
    if counters or gauges or hists:
        lines.append("")
        lines.append("metrics:")
        for name, v in sorted(counters.items()):
            lines.append(f"  {name:<32} {v:g}")
        for name, v in sorted(gauges.items()):
            lines.append(f"  {name:<32} {v:g}")
        for name, st in sorted(hists.items()):
            lines.append(
                f"  {name:<32} n={st.get('count', 0)} "
                f"mean={st.get('mean', 0):g} p50={st.get('p50', 0):g} "
                f"p95={st.get('p95', 0):g} max={st.get('max', 0):g}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarise an exported repro_torch.obs Chrome trace")
    ap.add_argument("trace", help="path to the trace JSON "
                                  "(obs.export_chrome_trace output)")
    ap.add_argument("--top", type=int, default=15,
                    help="how many slowest spans to list (default 15)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    try:
        print(summarise(doc, top=args.top))
    except BrokenPipeError:                 # `... | head` is normal usage
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
