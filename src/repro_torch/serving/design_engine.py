"""Async request-queue serving engine over compiled ``Design`` artifacts.

``Design.serve`` is a warmed *synchronous* loop: the caller owns batching
and blocks per batch.  This engine is the deployment-shaped front: callers
:meth:`~DesignEngine.submit` single samples from any thread; a dispatcher
accumulates them in a thread-safe queue and fires a batch when either

  * **size trigger** — the queue reaches the largest bucket, or
  * **deadline trigger** — the oldest request has waited ``max_delay_ms``

whichever comes first.  Dispatched batch sizes are snapped to a small set
of pre-warmed **bucket** shapes (padding up to the next bucket when a
deadline flush catches a partial batch).  On the card each bucket is a
CUDA graph captured at boot (``Design._runner``), so every dispatch copies
its batch in and replays an already-captured graph — no capture and no
per-kernel launch from Python on the hot path, the OpenHLS static-shape
discipline applied to serving.

Fault tolerance wires :mod:`repro_torch.runtime.fault` in: an optional
``FailureInjector`` poisons chosen dispatches (tests), any dispatch
exception triggers a replica restart — re-booting from the saved
``Design.save`` artifact when ``artifact_path`` is given — and the failed
batch is re-queued at the head *in order*, so no request is dropped and a
drained rerun is bit-identical to an uninterrupted one.  A restart
releases the old replica's graphs before it boots anew.  A
``StepWatchdog`` records straggler dispatches.

All three serving backends serve: ``tensor`` (the plain tensor twin),
``simd`` (emitted design), ``cuda`` (compiled rendering on the
hand-written kernels).  Each request's result is a numpy array (or a dict
of them), copied to the host before the next dispatch.  The engine
reports sustained QPS, p50/p95/p99 latency and queue depth.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch import obs
from repro_torch.core import device as devices
from repro_torch.runtime.fault import FailureInjector, StepWatchdog
from repro_torch.serving.common import (QueuedRequest, RequestQueue,
                                        percentiles)


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to ``max_batch`` (plus ``max_batch`` itself): the
    pre-warmed dispatch shapes."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


@dataclasses.dataclass
class EngineReport:
    """Telemetry of one :class:`DesignEngine` lifetime.

    Comparable with :class:`repro_torch.hls.ServeReport` — both carry
    p50/p95/p99 latency and queue-depth fields, so the sync and async
    serving paths land in one table.
    """

    backend: str
    fmt: Optional[str]
    #: last replica boot time (runner build + bucket warm-up), seconds
    boot_s: float = 0.0
    #: source of every replica boot, in order: "memory" or "artifact"
    boots: list = dataclasses.field(default_factory=list)
    submitted: int = 0
    completed: int = 0
    dropped: int = 0
    retried: int = 0
    restarts: int = 0
    dispatches: int = 0
    #: bucket size -> dispatch count
    batch_hist: dict = dataclasses.field(default_factory=dict)
    padded_samples: int = 0
    wall_s: float = 0.0
    #: cumulative on-device batch compute time across dispatches, seconds
    compute_s: float = 0.0
    qps: float = 0.0
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    mean_ms: float = 0.0
    max_queue_depth: int = 0
    #: time-weighted over the full queue-depth transition log (idle and
    #: ramp periods included), not just the instants a dispatch sampled
    mean_queue_depth: float = 0.0
    p95_queue_depth: float = 0.0
    straggler_dispatches: list = dataclasses.field(default_factory=list)
    #: what actually served (the CUDA plan summary when applicable)
    served: Optional[str] = None
    fallbacks: list = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        fmt = "fp32" if self.fmt in (None, "fp32") else \
            f"({self.fmt.replace('_', ',')})"
        hist = ", ".join(f"{b}x{n}" for b, n in sorted(self.batch_hist.items()))
        return (f"served {self.completed}/{self.submitted} requests @ "
                f"{self.qps:.1f} req/s: p50 {self.p50_ms:.2f} / "
                f"p95 {self.p95_ms:.2f} / p99 {self.p99_ms:.2f} ms "
                f"[{self.served or self.backend} backend, {fmt}; "
                f"{self.dispatches} dispatches ({hist}), "
                f"max queue {self.max_queue_depth}, "
                f"{self.restarts} restarts, {self.dropped} dropped; "
                f"boot {self.boot_s:.2f}s]")


class DesignEngine:
    """Adaptive-batching request engine fronting one compiled ``Design``.

    Construct via :meth:`repro_torch.hls.Design.engine` (which defaults
    ``backend``/``fmt``/``buckets`` from the saved artifact's warmed-bucket
    manifest when the design was loaded with ``hls.load``).

    Two run modes:

      * **threaded** — ``start()`` (or the context manager) spawns the
        dispatcher; ``submit`` from any thread; ``stop()`` drains and
        joins.  The open-loop load generators drive this mode.
      * **synchronous** — without ``start()``, ``submit`` everything and
        call :meth:`run_until_drained`; dispatch grouping is then
        deterministic (head-of-queue batches of ``min(pending,
        max_batch)``), which is what the bit-identity tests rely on.

    ``backend`` defaults as :meth:`Design.serve` does (``tensor`` when the
    design has a bound tensor twin, else ``cuda``); the engine serves on
    the design's device; ``cuda_kw`` forwards to the ``cuda`` lowering.
    """

    def __init__(self, design, *, backend: Optional[str] = None,
                 fmt: Optional[str] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 32, max_delay_ms: float = 2.0,
                 artifact_path: Optional[Union[str, Path]] = None,
                 injector: Optional[FailureInjector] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 max_restarts: int = 4, max_retries: int = 2,
                 cuda_kw: Optional[dict] = None, warm: bool = True):
        if backend is None:
            module = design.module
            backend = ("tensor" if module is not None
                       and module.forward_fn is not None
                       and module.params is not None else "cuda")
        self.backend = backend
        self.fmt = fmt
        self.device = design.device
        self.buckets = (tuple(sorted(set(int(b) for b in buckets)))
                        if buckets else default_buckets(max_batch))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {self.buckets}")
        self.max_batch = self.buckets[-1]
        self.max_delay_s = max_delay_ms * 1e-3
        self.artifact_path = Path(artifact_path) if artifact_path else None
        self.injector = injector or FailureInjector()
        self.watchdog = watchdog or StepWatchdog()
        self.max_restarts = max_restarts
        self.max_retries = max_retries
        self.cuda_kw = dict(cuda_kw or {})

        self._design = design
        self._input_name, self._input_shape = design._input_memref()
        self._input_shape = tuple(self._input_shape)
        if backend == "tensor" and self._input_shape[0] != 1:
            raise ValueError(
                f"tensor backend batches over the memref's leading "
                f"singleton axis; input {self._input_name!r} has shape "
                f"{self._input_shape}")
        self._queue = RequestQueue()
        self._finished: list[QueuedRequest] = []
        self._report = EngineReport(backend=backend, fmt=fmt)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._run_one = None
        if warm:
            self._boot("memory")

    # -- replica lifecycle --------------------------------------------------

    def _boot(self, source: str) -> float:
        """(Re)build the serving replica and warm every bucket shape.

        ``source='artifact'`` re-loads the design from ``artifact_path``
        (the warm-boot path a restarted replica takes); ``'memory'``
        rebuilds from the in-process design.  The old replica's captured
        graphs are released first; warming a bucket on the card captures
        its graph.  Returns the boot wall time.
        """
        t0 = time.perf_counter()
        if self._run_one is not None:
            self._run_one.release()
            self._run_one = None
        with obs.span("serve.boot", cat="serve", source=source,
                      backend=self.backend, buckets=list(self.buckets)):
            if source == "artifact":
                import repro_torch.hls as hls
                self._design = hls.load(self.artifact_path,
                                        session=self._design.session)
            run_one, served, fallbacks = self._design._runner(
                self.backend, self.fmt, self.device, self.cuda_kw)
            self._report.served = served
            self._report.fallbacks = list(fallbacks)
            for b in self.buckets:                   # pre-warm every shape
                run_one(np.zeros((b,) + self._input_shape, np.float32))
                devices.synchronize(self.device)
            self._run_one = run_one
        boot_s = time.perf_counter() - t0
        obs.inc("serve.boots")
        self._report.boot_s = boot_s
        self._report.boots.append(source)
        return boot_s

    # -- submission ---------------------------------------------------------

    def _coerce_sample(self, x) -> np.ndarray:
        arr = np.asarray(x, dtype=np.float32)
        shape = self._input_shape
        if arr.shape == tuple(shape):
            return arr
        if shape[0] == 1 and arr.shape == tuple(shape)[1:]:
            return arr[None]
        raise ValueError(
            f"sample shape {arr.shape} does not match input memref "
            f"{self._input_name!r} shape {tuple(shape)}")

    def submit(self, x) -> QueuedRequest:
        """Enqueue one sample; returns the request (its own future —
        ``req.wait()`` blocks for the per-sample output)."""
        if self._stop_evt.is_set():
            raise RuntimeError("engine is stopped")
        req = self._queue.submit(self._coerce_sample(x))
        if self._t_first is None:
            self._t_first = req.submit_t
        return req

    def submit_many(self, xs) -> list[QueuedRequest]:
        return [self.submit(x) for x in xs]

    # -- dispatch -----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    @staticmethod
    def _split(out, i: int):
        if isinstance(out, dict):
            return {k: v[i] for k, v in out.items()}
        return out[i]

    def _dispatch(self, reqs: list[QueuedRequest]) -> None:
        """Run one snapped batch; on failure, restart the replica and
        re-queue the batch at the head (never dropped, never reordered)."""
        rep = self._report
        idx = rep.dispatches
        rep.dispatches += 1
        bucket = self._bucket_for(len(reqs))
        now = time.monotonic()
        for r in reqs:
            r.start_t = now
        stacked = np.stack([r.payload for r in reqs])
        if bucket > len(reqs):
            rep.padded_samples += bucket - len(reqs)
            pad = np.zeros((bucket - len(reqs),) + self._input_shape,
                           np.float32)
            stacked = np.concatenate([stacked, pad])
        obs.inc("serve.dispatches")
        obs.inc("serve.padded_samples", bucket - len(reqs))
        obs.observe("serve.batch_occupancy", len(reqs) / bucket)
        with obs.span("serve.dispatch", cat="serve", dispatch=idx,
                      n=len(reqs), bucket=bucket,
                      padded=bucket - len(reqs)) as disp_sp:
            t0 = time.perf_counter()
            try:
                self.injector.check(idx)
                with devices.host_threads(self.device, bucket):
                    out = self._run_one(stacked)
                devices.synchronize(self.device)
            except Exception as exc:
                rep.restarts += 1
                obs.inc("serve.restarts")
                disp_sp.set(error=type(exc).__name__)
                if rep.restarts > self.max_restarts:
                    for r in reqs:
                        r.finish(error=exc)
                    rep.dropped += len(reqs)
                    obs.inc("serve.requests_dropped", len(reqs))
                    self._record_request_spans(reqs, idx, bucket)
                    self._finished.extend(reqs)
                    return
                keep = [r for r in reqs if r.retries < self.max_retries]
                for r in reqs:
                    if r.retries >= self.max_retries:
                        r.finish(error=exc)
                        rep.dropped += 1
                        obs.inc("serve.requests_dropped")
                        self._record_request_spans([r], idx, bucket)
                        self._finished.append(r)
                rep.retried += len(keep)
                self._queue.requeue_front(keep)
                self._boot("artifact" if self.artifact_path else "memory")
                return
            dt = time.perf_counter() - t0
            disp_sp.set(compute_ms=round(dt * 1e3, 3))
        self.watchdog.observe(idx, dt)
        rep.compute_s += dt
        rep.batch_hist[bucket] = rep.batch_hist.get(bucket, 0) + 1
        out = devices.to_host(out)       # before the next replay
        for i, r in enumerate(reqs):
            r.finish(result=self._split(out, i))
        rep.completed += len(reqs)
        obs.inc("serve.requests_completed", len(reqs))
        self._record_request_spans(reqs, idx, bucket)
        self._finished.extend(reqs)
        self._t_last = time.monotonic()

    def _record_request_spans(self, reqs: list[QueuedRequest], idx: int,
                              bucket: int) -> None:
        """One async span per finished request (submit -> complete),
        linked to its dispatch by the ``dispatch`` attribute."""
        if not obs.enabled():
            return
        for r in reqs:
            obs.record_span(
                "serve.request", r.submit_t, r.done_t, cat="serve",
                kind="async", rid=r.rid, dispatch=idx, bucket=bucket,
                retries=r.retries, error=type(r.error).__name__
                if r.error is not None else None,
                queued_ms=round((r.start_t - r.submit_t) * 1e3, 3))

    def _dispatch_ready(self, *, flush: bool) -> bool:
        """Dispatch one batch if a trigger fired; True when work was done.

        Size trigger: pending >= the largest bucket (dispatched unpadded).
        Deadline trigger (or ``flush``): oldest request waited past
        ``max_delay_ms`` — dispatch what is pending, padded up to the next
        bucket so the shape is pre-warmed.
        """
        n = len(self._queue)
        if n == 0:
            return False
        if n < self.max_batch and not flush:
            age = self._queue.oldest_age_s()
            if age is None or age < self.max_delay_s:
                return False
        reqs = self._queue.pop_batch(min(n, self.max_batch))
        if reqs:
            self._dispatch(reqs)
        return bool(reqs)

    def run_until_drained(self) -> None:
        """Synchronous mode: dispatch head-of-queue batches until empty."""
        while self._dispatch_ready(flush=True):
            pass

    # -- threaded mode ------------------------------------------------------

    #: dispatcher-loop queue-depth sampling interval (timer-driven, so
    #: idle/ramp depth lands in the telemetry between dispatches)
    DEPTH_SAMPLE_S = 0.005

    def _loop(self) -> None:
        last_sample = time.monotonic()
        while True:
            now = time.monotonic()
            if now - last_sample >= self.DEPTH_SAMPLE_S:
                last_sample = now
                self._queue.sample_depth()
            if self._stop_evt.is_set():
                if not self._dispatch_ready(flush=True):
                    return
                continue
            if not self._queue.wait_for_work(timeout=0.005):
                continue
            if not self._dispatch_ready(flush=False):
                # a partial batch inside its deadline window: sleep a
                # slice, re-check (the queue may reach the size trigger)
                age = self._queue.oldest_age_s()
                if age is not None:
                    time.sleep(max(0.0, min(self.max_delay_s - age, 1e-3)))

    def start(self) -> "DesignEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="design-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue, then stop the dispatcher."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        else:
            self.run_until_drained()

    def __enter__(self) -> "DesignEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- reporting ----------------------------------------------------------

    def report(self) -> EngineReport:
        rep = self._report
        rep.submitted = self._queue.submitted
        lats = [r.latency_s for r in self._finished if r.error is None]
        pct = percentiles(lats)
        rep.p50_ms = pct["p50"] * 1e3
        rep.p95_ms = pct["p95"] * 1e3
        rep.p99_ms = pct["p99"] * 1e3
        rep.mean_ms = float(np.mean(lats)) * 1e3 if lats else 0.0
        depth = self._queue.depth_stats()
        rep.max_queue_depth = depth["max"]
        rep.mean_queue_depth = round(depth["mean"], 2)
        rep.p95_queue_depth = round(depth["p95"], 2)
        rep.straggler_dispatches = list(self.watchdog.stragglers)
        if self._t_first is not None and self._t_last is not None \
                and self._t_last > self._t_first:
            rep.wall_s = self._t_last - self._t_first
            rep.qps = rep.completed / rep.wall_s
        if rep.completed and rep.compute_s:
            obs.gauge(f"serve.us_per_sample.{self.backend}",
                      rep.compute_s / rep.completed * 1e6)
        return rep
