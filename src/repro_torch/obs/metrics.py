"""Process-wide metrics: counters, gauges, histograms.

One ``MetricsRegistry`` (the module singleton lives in ``repro_torch.obs``)
holds every metric by dotted name — ``design_cache.hits``,
``serve.queue_depth`` — lazily created on first touch so instrumentation
sites never pre-register.  ``snapshot()`` returns a plain dict (embedded
into ``BENCH_<date>.json`` and Chrome-trace ``otherData``);
``to_prometheus()`` renders the text exposition format for scrape-style
consumers.

Stdlib-only on purpose (manual percentiles, no numpy): the registry must
be importable — and near-free when disabled — everywhere the compiler
is.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple, Union

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def _percentile(sorted_vals: List[float], pct: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(0, min(len(sorted_vals) - 1,
                      math.ceil(pct / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[rank]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Sample distribution with exact count/sum/min/max and percentiles
    over the kept samples.  Keeps at most ``max_samples`` raw values
    (first-N; count/sum/min/max stay exact beyond the cap) so a
    long-lived server cannot grow without bound."""

    __slots__ = ("name", "_lock", "_samples", "_count", "_sum",
                 "_min", "_max", "max_samples")

    def __init__(self, name: str, max_samples: int = 100_000):
        self.name = name
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self.max_samples = max_samples

    def observe(self, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            return
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = value if self._min is None else min(self._min, value)
            self._max = value if self._max is None else max(self._max, value)
            if len(self._samples) < self.max_samples:
                self._samples.append(value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def stats(self) -> Dict[str, float]:
        with self._lock:
            n, total = self._count, self._sum
            lo, hi = self._min, self._max
            vals = sorted(self._samples)
        if n == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": n,
            "sum": round(total, 6),
            "min": lo if lo is not None else 0.0,
            "max": hi if hi is not None else 0.0,
            "mean": round(total / n, 6),
            "p50": _percentile(vals, 50),
            "p95": _percentile(vals, 95),
            "p99": _percentile(vals, 99),
        }


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named metrics, created lazily on first use.  Re-requesting a name
    with a different kind raises — one name, one kind, process-wide."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls: type) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    # -- convenience write paths (used by the guarded obs.* helpers) ------
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    # -- export -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain-dict view: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,min,max,mean,p50,p95,p99}}}``."""
        with self._lock:
            items: List[Tuple[str, Metric]] = sorted(self._metrics.items())
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.stats()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters, gauges, and histograms
        as summaries with quantile labels)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            pname = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value:g}")
            else:
                st = m.stats()
                lines.append(f"# TYPE {pname} summary")
                for q in (50, 95, 99):
                    lines.append(
                        f'{pname}{{quantile="0.{q}"}} {st[f"p{q}"]:g}')
                lines.append(f"{pname}_sum {st['sum']:g}")
                lines.append(f"{pname}_count {st['count']:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
