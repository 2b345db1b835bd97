"""Zero-dependency tracing: nested spans over a process-wide ``Tracer``.

A span is one timed region (``with tracer.span("passes.cse", ops=n):``)
with a name, a category, wall-clock bounds on the shared monotonic
clock, the recording thread, free-form attributes, and a parent link so
nesting survives the flat event list.  Nesting is tracked per thread
(thread-local span stack), the finished-span list is lock-protected, and
retroactive spans can be recorded from explicit timestamps
(``tracer.record(...)``) — that is how per-request serving spans are
reconstructed from ``QueuedRequest`` timestamps after the fact.

The module is stdlib-only by design: it must import (and no-op) in any
environment the compiler runs in, including ones without jax/numpy.
Chrome-trace rendering of the recorded spans lives in
:mod:`repro_torch.obs.export`.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional


@dataclasses.dataclass
class Span:
    """One finished timed region.  ``t0``/``t1`` are ``time.monotonic()``
    seconds (same clock as ``serving.common.QueuedRequest``)."""

    name: str
    cat: str = ""
    t0: float = 0.0
    t1: float = 0.0
    tid: int = 0
    thread: str = ""
    span_id: int = 0
    parent_id: Optional[int] = None
    kind: str = "complete"          # "complete" | "async" | "instant"
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes to an open (or finished) span."""
        self.attrs.update(attrs)
        return self


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracer fast path.  A single
    module-level instance is returned from every ``obs.span(...)`` call
    while tracing is off, so the disabled cost is one attribute load and
    one truthiness check — no allocation, no clock read."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _ActiveSpan:
    """Context manager binding one ``Span`` to a ``Tracer``: entry reads
    the clock and pushes onto the thread-local nesting stack, exit pops
    and appends the finished span to the tracer."""

    __slots__ = ("span", "_tracer")

    def __init__(self, tracer: "Tracer", span: Span):
        self.span = span
        self._tracer = tracer

    def __enter__(self) -> Span:
        stack = self._tracer._stack()
        if stack:
            self.span.parent_id = stack[-1].span_id
        stack.append(self.span)
        self.span.t0 = time.monotonic()
        return self.span

    def __exit__(self, *exc: Any) -> bool:
        self.span.t1 = time.monotonic()
        stack = self._tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        elif self.span in stack:        # unbalanced exit; stay consistent
            stack.remove(self.span)
        self._tracer._append(self.span)
        return False


class Tracer:
    """Thread-safe collector of finished spans.

    ``span()`` opens a nested region on the calling thread; ``record()``
    logs a span retroactively from explicit timestamps; ``event()`` logs
    an instant.  ``spans()`` snapshots the finished list.  The collector
    caps at ``max_spans`` and counts overflow in ``dropped`` rather than
    growing without bound on long-lived servers.
    """

    def __init__(self, max_spans: int = 200_000):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.max_spans = max_spans
        self.dropped = 0
        #: monotonic origin for trace-relative timestamps (export uses it)
        self.epoch = time.monotonic()

    # -- internals --------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(span)
            else:
                self.dropped += 1

    def _new_span(self, name: str, cat: str, kind: str,
                  attrs: Dict[str, Any]) -> Span:
        th = threading.current_thread()
        return Span(name=name, cat=cat, tid=th.ident or 0, thread=th.name,
                    span_id=next(self._ids), kind=kind, attrs=attrs)

    # -- recording --------------------------------------------------------
    def span(self, name: str, cat: str = "", **attrs: Any) -> _ActiveSpan:
        """``with tracer.span("compile.passes", ops=n) as sp:`` — nested
        under whatever span is currently open on this thread."""
        return _ActiveSpan(self, self._new_span(name, cat, "complete", attrs))

    def record(self, name: str, t0: float, t1: float, *, cat: str = "",
               kind: str = "complete", parent_id: Optional[int] = None,
               **attrs: Any) -> Span:
        """Record a span retroactively from explicit ``time.monotonic()``
        bounds (e.g. a request's submit→complete window)."""
        span = self._new_span(name, cat, kind, attrs)
        span.t0, span.t1, span.parent_id = t0, t1, parent_id
        self._append(span)
        return span

    def event(self, name: str, cat: str = "", **attrs: Any) -> Span:
        """Record an instantaneous event at the current time."""
        now = time.monotonic()
        return self.record(name, now, now, cat=cat, kind="instant", **attrs)

    def current(self) -> Optional[Span]:
        """The innermost open span on the calling thread, if any."""
        stack = self._stack()
        return stack[-1] if stack else None

    # -- inspection -------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def __iter__(self) -> Iterator[Span]:
        return iter(self.spans())

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
