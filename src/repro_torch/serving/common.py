"""Queue/lane bookkeeping shared by the serving engines and the trigger.

The LM continuous-batching engine (:mod:`repro_torch.serving.engine`), the
compiled-``Design`` request engine (:mod:`repro_torch.serving.design_engine`)
and the hard-real-time trigger loop (:mod:`repro_torch.trigger.stream`) need
the same machinery: request identity + lifecycle timestamps, thread-safe
queues with depth telemetry, and tail-latency percentiles.  It lives
here once instead of being copy-pasted per engine; nothing in this
module imports models, configs or the compiler, so every consumer can be
used standalone.

Two queue disciplines, two worlds:

  * :class:`RequestQueue` — unbounded FIFO; a slow server grows the
    queue (request/response serving, where dropping is the failure);
  * :class:`DropOldestRing` — bounded ring that *never* blocks or grows;
    a slow consumer loses the **oldest** entries (streaming front-ends,
    where back-pressuring the producer — a detector — is the failure).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch import obs


def percentiles(values: Sequence[float],
                pcts: Sequence[int] = (50, 95, 99)) -> dict[str, float]:
    """``{"p50": ..., "p95": ..., "p99": ...}`` over ``values`` (0.0 when
    empty) — the tail-latency summary both serve reports share.  NaNs are
    rejected rather than poisoning every percentile; an all-NaN or empty
    input reports zeros."""
    if not len(values):
        return {f"p{p}": 0.0 for p in pcts}
    arr = np.asarray(values, dtype=np.float64)
    arr = arr[~np.isnan(arr)]
    if not arr.size:
        return {f"p{p}": 0.0 for p in pcts}
    return {f"p{p}": float(np.percentile(arr, p)) for p in pcts}


@dataclasses.dataclass
class QueuedRequest:
    """One queued unit of work plus its lifecycle timestamps.

    ``payload`` is engine-defined (an input sample for the design engine, a
    token prompt for the LM engine).  The submit/start/done timestamps give
    per-request latency; ``retries`` counts re-queues after a replica
    failure.  ``wait()``/``ready`` make the request its own future: the
    dispatching engine fills ``result`` (or ``error``) and sets the event.
    """

    rid: int
    payload: Any
    submit_t: float = 0.0
    start_t: float = 0.0
    done_t: float = 0.0
    retries: int = 0
    result: Any = None
    error: Optional[BaseException] = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)

    @property
    def ready(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until the engine finished this request; returns the result
        (re-raising the engine-side error, if any)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done "
                               f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    def finish(self, result: Any = None,
               error: Optional[BaseException] = None) -> None:
        self.done_t = time.monotonic()
        self.result = result
        self.error = error
        self._done.set()

    @property
    def latency_s(self) -> float:
        return self.done_t - self.submit_t if self.done_t else 0.0


class RequestQueue:
    """Thread-safe FIFO of :class:`QueuedRequest` with depth telemetry.

    Owns rid assignment and the submit timestamp so every engine reports
    comparable latencies.  Depth telemetry is recorded two ways: the
    legacy ``depth_samples`` value list, and ``depth_events`` — the full
    ``(monotonic_t, depth)`` transition log from every push/pop/requeue
    plus any timer-driven ``sample_depth()`` calls.  ``depth_stats()``
    integrates that step function for *time-weighted* mean/p95/max, so a
    bursty queue that sits deep between dispatches is reported at its
    true depth instead of only at the instants the engine touched it.
    ``requeue_front`` puts a failed batch back at the head *in order*,
    which is what keeps replica restarts from dropping or reordering
    in-flight requests.
    """

    def __init__(self):
        self._items: list[QueuedRequest] = []
        self._cond = threading.Condition()
        self._next_rid = 0
        self.submitted = 0
        self.depth_samples: list[int] = []
        self.depth_events: list[tuple[float, int]] = []

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def submit(self, payload: Any) -> QueuedRequest:
        return self.push(QueuedRequest(rid=-1, payload=payload))

    def push(self, req: QueuedRequest) -> QueuedRequest:
        """Enqueue a pre-built request (engines subclass
        :class:`QueuedRequest` with their own fields); the queue owns rid
        assignment and the submit timestamp."""
        with self._cond:
            req.rid = self._next_rid
            req.submit_t = time.monotonic()
            self._next_rid += 1
            self._items.append(req)
            self.submitted += 1
            self._note_depth()
            self._cond.notify_all()
            return req

    def pop(self) -> Optional[QueuedRequest]:
        """Pop the oldest request (None when empty)."""
        batch = self.pop_batch(1)
        return batch[0] if batch else None

    def pop_batch(self, n: int) -> list[QueuedRequest]:
        """Pop up to ``n`` requests preserving FIFO order."""
        with self._cond:
            taken, self._items = self._items[:n], self._items[n:]
            if taken:
                self._note_depth()
            return taken

    def requeue_front(self, reqs: Sequence[QueuedRequest]) -> None:
        """Put ``reqs`` back at the head (in the given order) after a
        replica failure; bumps each request's retry counter."""
        with self._cond:
            for r in reqs:
                r.retries += 1
            self._items[:0] = list(reqs)
            if reqs:
                self._note_depth()
            self._cond.notify_all()

    def oldest_age_s(self) -> Optional[float]:
        """Age of the head request (None when empty) — the deadline
        trigger's input."""
        with self._cond:
            if not self._items:
                return None
            return time.monotonic() - self._items[0].submit_t

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is non-empty (or timeout); True if work."""
        with self._cond:
            if self._items:
                return True
            self._cond.wait(timeout)
            return bool(self._items)

    # -- telemetry ----------------------------------------------------------

    def _note_depth(self) -> None:
        """Record the current depth (call under ``self._cond``)."""
        depth = len(self._items)
        self.depth_samples.append(depth)
        self.depth_events.append((time.monotonic(), depth))
        obs.observe("serve.queue_depth", depth)

    def sample_depth(self) -> int:
        """Timer-driven depth observation (the engine loop calls this so
        idle/ramp periods appear in the telemetry, not just the instants a
        push or dispatch happened to touch the queue)."""
        with self._cond:
            self._note_depth()
            return len(self._items)

    @property
    def max_depth(self) -> int:
        return max(self.depth_samples, default=0)

    @property
    def mean_depth(self) -> float:
        return (float(np.mean(self.depth_samples))
                if self.depth_samples else 0.0)

    def depth_stats(self) -> dict[str, float]:
        """Time-weighted depth statistics over the transition log.

        Each recorded depth holds from its event until the next one; the
        step function is integrated exactly, so 300 ms spent at depth 8
        dominates a handful of instantaneous dispatch touches.  With
        fewer than two events this degrades to the plain values.  Returns
        ``{"max", "mean", "p95"}``.
        """
        with self._cond:
            events = list(self.depth_events)
        if not events:
            return {"max": 0, "mean": 0.0, "p95": 0.0}
        if len(events) == 1:
            d = float(events[0][1])
            return {"max": int(d), "mean": d, "p95": d}
        total = events[-1][0] - events[0][0]
        if total <= 0:
            vals = [d for _, d in events]
            return {"max": max(vals), "mean": float(np.mean(vals)),
                    "p95": float(np.percentile(vals, 95))}
        weight: dict[int, float] = {}
        for (t0, d), (t1, _) in zip(events, events[1:]):
            weight[d] = weight.get(d, 0.0) + (t1 - t0)
        mean = sum(d * w for d, w in weight.items()) / total
        p95 = float(max(weight))       # fallback if rounding never trips
        acc = 0.0
        for d in sorted(weight):
            acc += weight[d]
            if acc >= 0.95 * total:
                p95 = float(d)
                break
        return {"max": max(d for _, d in events), "mean": mean, "p95": p95}


class DropOldestRing:
    """Bounded buffer whose producer can never be blocked or slowed.

    Pushing onto a full ring evicts the **oldest** entry (returned to the
    caller, counted in ``dropped``) instead of blocking, growing, or
    refusing — the overrun policy of a hard-real-time front-end: a
    trigger must never back-pressure the detector, and when it falls
    behind the *stalest* frames are the right ones to lose.  A single
    mutex guards O(1) deque operations, so the producer-side critical
    section is a few dozen nanoseconds — not lock-free, but never
    producer-visible at detector frame rates.

    FIFO otherwise: ``pop``/``pop_many`` return survivors oldest-first.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.pushed = 0
        self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def push(self, item: Any) -> Optional[Any]:
        """Append ``item``; returns the evicted oldest entry on overrun
        (``None`` when the ring had room)."""
        with self._lock:
            evicted = None
            if len(self._items) >= self.capacity:
                evicted = self._items.popleft()
                self.dropped += 1
            self._items.append(item)
            self.pushed += 1
        if evicted is not None:
            obs.inc("trigger.dropped_frames")
        return evicted

    def pop(self) -> Optional[Any]:
        """The oldest surviving entry, or ``None`` when empty."""
        with self._lock:
            return self._items.popleft() if self._items else None

    def pop_many(self, n: int) -> list:
        """Up to ``n`` oldest survivors, oldest-first."""
        with self._lock:
            out = []
            while self._items and len(out) < n:
                out.append(self._items.popleft())
            return out

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
