"""Fixed-rate streaming trigger loop: detector feed -> ring -> decisions.

The deployment OpenHLS targets (and the collider-trigger study in
PAPERS.md frames explicitly): sensor frames arrive on the *experiment's*
clock, every frame must become an accept/reject decision within a fixed
latency budget, and the trigger must never back-pressure the detector —
when it falls behind, the stalest frames are dropped, not queued.

Three pieces:

  * :class:`DetectorFeed` — seeded synthetic Bragg-peak frame generator
    with a configurable event rate and periodic **pileup bursts**
    (several peaks per frame), so every backend and every PR sees the
    same stream bit-for-bit;
  * the bounded drop-oldest ring
    (:class:`repro_torch.serving.common.DropOldestRing`) between producer
    and trigger — the explicit overrun policy;
  * :class:`TriggerLoop` — pulls fixed-size windows, runs them through a
    pre-warmed ``Design._runner`` (any serving backend; on the card the
    window shape is a captured CUDA graph, replayed per window), copies
    the window's outputs to the host, applies a threshold predicate, and
    emits :class:`TriggerDecision` records with per-window deadline
    accounting (met/missed, slack µs).

Two run modes: ``realtime=True`` paces arrivals on the wall clock with a
producer thread (drops and queueing latency are real); the default
deterministic mode processes every frame in order — decisions are then a
pure function of the seed, which is what the bit-identity tests and the
tuning gate rely on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import device as devices
from repro_torch.serving.common import DropOldestRing, percentiles
from repro_torch.trigger.budget import TriggerBudget

log = obs.get_logger(__name__)


# ---------------------------------------------------------------------------
# Synthetic detector feed
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Frame:
    """One detector frame: pixels plus its place in the stream."""

    frame_id: int
    data: np.ndarray              # the input memref, (1, 1, img, img)
    t_sched: float                # scheduled arrival offset from start (s)
    n_peaks: int                  # ground truth (feed bookkeeping only)
    arrival_t: float = 0.0        # wall-clock arrival (realtime mode)


@dataclasses.dataclass
class DetectorFeed:
    """Seeded Bragg-peak frame generator at a fixed frame rate.

    Each frame is Gaussian pixel noise; with probability ``event_rate``
    it carries one Gaussian peak (random sub-pixel centre, amplitude and
    width).  Every ``pileup_every`` frames, ``pileup_len`` consecutive
    frames are a **pileup burst** carrying ``pileup_peaks`` overlapping
    peaks each — the detector pathology a trigger must survive.  The
    stream is a pure function of ``seed``: same seed, same frames,
    bit-for-bit.
    """

    img: int = 11
    frame_rate_hz: float = 1000.0
    event_rate: float = 0.6
    pileup_every: int = 50
    pileup_len: int = 5
    pileup_peaks: int = 3
    noise: float = 0.05
    amplitude: tuple = (0.6, 1.4)
    sigma: tuple = (0.8, 1.6)
    seed: int = 0

    def _render(self, rng: np.random.Generator, n_peaks: int) -> np.ndarray:
        img = self.img
        frame = rng.normal(0.0, self.noise, (img, img)).astype(np.float32)
        yy, xx = np.mgrid[0:img, 0:img].astype(np.float32)
        for _ in range(n_peaks):
            cy, cx = rng.uniform(1.0, img - 2.0, 2)
            amp = rng.uniform(*self.amplitude)
            sig = rng.uniform(*self.sigma)
            frame += (amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                   / (2.0 * sig * sig))).astype(np.float32)
        return frame[None, None]       # the (1, 1, img, img) input memref

    def frames(self, n: int) -> Iterator[Frame]:
        """The first ``n`` frames of the seeded stream."""
        rng = np.random.default_rng(self.seed)
        dt = 1.0 / self.frame_rate_hz
        for i in range(n):
            if self.pileup_every and i % self.pileup_every < self.pileup_len:
                n_peaks = self.pileup_peaks
            else:
                n_peaks = int(rng.random() < self.event_rate)
            yield Frame(frame_id=i, data=self._render(rng, n_peaks),
                        t_sched=i * dt, n_peaks=n_peaks)

    def describe(self) -> dict:
        return {"img": self.img, "frame_rate_hz": self.frame_rate_hz,
                "event_rate": self.event_rate,
                "pileup_every": self.pileup_every,
                "pileup_len": self.pileup_len,
                "pileup_peaks": self.pileup_peaks, "seed": self.seed}


# ---------------------------------------------------------------------------
# Decisions + report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TriggerDecision:
    """One frame's verdict plus its deadline accounting."""

    frame_id: int
    accept: bool
    score: float
    latency_us: float             # arrival (or window start) -> decision
    deadline_met: bool            # True when no deadline was configured
    slack_us: float               # budget - latency (negative = missed)


@dataclasses.dataclass
class TriggerReport:
    """Stream-level accounting of one :meth:`TriggerLoop.run`."""

    backend: str
    fmt: Optional[str]
    window: int
    realtime: bool
    frames: int = 0               # offered by the feed
    processed: int = 0            # reached a decision
    dropped: int = 0              # lost to ring overrun
    windows: int = 0
    accepts: int = 0
    rejects: int = 0
    deadline_misses: int = 0
    deadline_us: Optional[float] = None
    p50_us: float = 0.0
    p95_us: float = 0.0
    p99_us: float = 0.0
    max_us: float = 0.0
    wall_s: float = 0.0
    sustained_fps: float = 0.0
    warmup_s: float = 0.0
    decisions: list = dataclasses.field(default_factory=list)

    @property
    def drop_pct(self) -> float:
        return 100.0 * self.dropped / self.frames if self.frames else 0.0

    @property
    def miss_pct(self) -> float:
        return (100.0 * self.deadline_misses / self.processed
                if self.processed else 0.0)

    def summary(self) -> str:
        deadline = (f", deadline {self.deadline_us:g} us: "
                    f"{self.deadline_misses} missed ({self.miss_pct:.1f}%)"
                    if self.deadline_us is not None else "")
        return (f"triggered {self.processed}/{self.frames} frames "
                f"({self.accepts} accept / {self.rejects} reject, "
                f"{self.dropped} dropped = {self.drop_pct:.1f}%) @ "
                f"{self.sustained_fps:.0f} fps sustained, decision p50 "
                f"{self.p50_us:.0f} / p95 {self.p95_us:.0f} / p99 "
                f"{self.p99_us:.0f} us{deadline} "
                f"[{self.backend} backend, warm-up {self.warmup_s:.2f}s]")

    def to_json(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if k != "decisions"}
        d["drop_pct"] = round(self.drop_pct, 3)
        d["miss_pct"] = round(self.miss_pct, 3)
        return d


# ---------------------------------------------------------------------------
# The trigger loop
# ---------------------------------------------------------------------------


def threshold_predicate(threshold: float) -> Callable:
    """The stock predicate: accept when any output magnitude clears
    ``threshold``.  Batched over the window's host outputs: returns
    per-sample ``(accepts, scores)``."""
    def predicate(outputs) -> tuple[np.ndarray, np.ndarray]:
        vals = (outputs.values() if isinstance(outputs, dict)
                else (outputs,))
        score = None
        for v in vals:
            arr = np.abs(np.asarray(v, dtype=np.float32))
            s = arr.reshape(arr.shape[0], -1).max(axis=1)
            score = s if score is None else np.maximum(score, s)
        return score >= threshold, score
    return predicate


class TriggerLoop:
    """Streaming accept/reject over a pre-warmed compiled design.

    ``design`` is a ``repro_torch.hls.Design``; the loop serves through
    the same ``Design._runner`` the sync/async serving paths use, so any
    serving backend (``tensor`` / ``simd`` / ``cuda``) triggers, on
    ``device`` (default: the design's).  ``window`` frames are stacked
    into one fixed-shape inference (the only shape warmed: on the card one
    captured CUDA graph, replayed per window); ``predicate`` maps the
    window's outputs, copied to the host as numpy, to per-frame
    ``(accepts, scores)`` (default: :func:`threshold_predicate`).
    ``budget.max_latency_us`` is the per-frame decision deadline; metrics
    land in ``repro_torch.obs``
    (``trigger.deadline_misses`` / ``trigger.dropped_frames`` counters,
    one ``trigger.window`` span per dispatched window).
    """

    def __init__(self, design, *, backend: Optional[str] = None,
                 fmt: Optional[str] = None,
                 budget: Optional[TriggerBudget] = None,
                 threshold: float = 0.75,
                 predicate: Optional[Callable] = None,
                 window: int = 1, capacity: int = 256,
                 cuda_kw: Optional[dict] = None, device=None,
                 warm: bool = True):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if backend is None:
            module = design.module
            backend = ("tensor" if module is not None
                       and module.forward_fn is not None
                       and module.params is not None else "cuda")
        self.design = design
        self.backend = backend
        self.fmt = fmt
        self.budget = budget
        self.window = window
        self.threshold = threshold
        self._user_predicate = predicate
        self.ring = DropOldestRing(capacity)
        self.device = (design.device if device is None
                       else devices.resolve(device))
        self._input_name, self._input_shape = design._input_memref()
        self._run_one, self._served, _ = design._runner(
            backend, fmt, self.device, dict(cuda_kw or {}))
        self.warmup_s = 0.0
        if warm:
            self.warmup()

    # -- plumbing ------------------------------------------------------------

    @property
    def predicate(self) -> Callable:
        """The active predicate (user-supplied, or the stock threshold
        predicate at the *current* ``self.threshold`` — so
        :meth:`calibrate` takes effect without rebuilding the loop)."""
        return self._user_predicate or threshold_predicate(self.threshold)

    def calibrate(self, feed: DetectorFeed, n_frames: int = 64, *,
                  quantile: float = 0.5) -> float:
        """Set ``threshold`` to the ``quantile`` of the stock predicate's
        scores over the feed's first ``n_frames``.

        A deployment calibrates its threshold on beam data exactly like
        this; here it pins a deterministic accept fraction (~``1 -
        quantile``) whatever the bound params' output scale.  Returns
        the chosen threshold.  No-op guard: refuses when a custom
        predicate is installed.
        """
        if self._user_predicate is not None:
            raise ValueError("calibrate() tunes the stock threshold "
                             "predicate; a custom predicate is installed")
        scores: list[float] = []
        score_of = threshold_predicate(float("inf"))
        batch: list[Frame] = []
        for frame in feed.frames(n_frames):
            batch.append(frame)
            if len(batch) == self.window:
                out = self._infer(np.stack([f.data for f in batch]))
                scores.extend(np.asarray(score_of(out)[1]).reshape(-1))
                batch = []
        if batch:
            n_real = len(batch)
            out = self._infer(np.stack([f.data for f in self._pad(batch)]))
            scores.extend(np.asarray(score_of(out)[1]).reshape(-1)[:n_real])
        self.threshold = float(np.quantile(np.asarray(scores), quantile))
        return self.threshold

    def warmup(self) -> float:
        """Warm the one window shape the hot loop will dispatch (on the
        card: capture its CUDA graph)."""
        t0 = time.perf_counter()
        zeros = np.zeros((self.window,) + tuple(self._input_shape),
                         np.float32)
        with obs.span("trigger.warmup", cat="trigger", backend=self.backend,
                      window=self.window):
            self._infer(zeros)
        self.warmup_s = time.perf_counter() - t0
        return self.warmup_s

    def _infer(self, stacked: np.ndarray):
        """One window through the runner, synchronised, its outputs copied
        to the host."""
        out = self._run_one(stacked.astype(np.float32, copy=False))
        devices.synchronize(self.device)
        return devices.to_host(out)          # before the next replay

    def _decide(self, frames: list[Frame], n_real: int, t_ref: list[float],
                report: TriggerReport) -> None:
        """One window: inference, predicate, deadline accounting."""
        stacked = np.stack([f.data for f in frames]).astype(np.float32)
        idx = report.windows
        report.windows += 1
        with obs.span("trigger.window", cat="trigger", window=idx,
                      frames=n_real, backend=self.backend) as sp:
            accepts, scores = self.predicate(self._infer(stacked))
            t_done = time.perf_counter()
            accepts = np.asarray(accepts).reshape(-1)[:n_real]
            scores = np.asarray(scores).reshape(-1)[:n_real]
            deadline = self.budget.max_latency_us \
                if self.budget is not None else None
            misses = 0
            for i in range(n_real):
                latency_us = (t_done - t_ref[i]) * 1e6
                met, slack = True, float("inf")
                if deadline is not None:
                    slack = deadline - latency_us
                    met = slack >= 0.0
                    misses += not met
                report.decisions.append(TriggerDecision(
                    frame_id=frames[i].frame_id, accept=bool(accepts[i]),
                    score=float(scores[i]), latency_us=latency_us,
                    deadline_met=met, slack_us=slack))
            n_acc = int(np.count_nonzero(accepts))
            report.processed += n_real
            report.accepts += n_acc
            report.rejects += n_real - n_acc
            report.deadline_misses += misses
            sp.set(accepts=n_acc, deadline_misses=misses)
        obs.inc("trigger.windows")
        obs.inc("trigger.accepts", n_acc)
        obs.inc("trigger.rejects", n_real - n_acc)
        if misses:
            obs.inc("trigger.deadline_misses", misses)

    def _pad(self, frames: list[Frame]) -> list[Frame]:
        """Zero-frames up to the warmed window shape (end of stream)."""
        pad = self.window - len(frames)
        zero = np.zeros(tuple(self._input_shape), np.float32)
        return frames + [Frame(frame_id=-1, data=zero, t_sched=0.0,
                               n_peaks=0)] * pad

    # -- run modes -----------------------------------------------------------

    def run(self, feed: DetectorFeed, n_frames: int, *,
            realtime: bool = False) -> TriggerReport:
        """Stream ``n_frames`` from ``feed`` through the trigger.

        Deterministic mode (default): every frame is processed in order —
        zero drops, decisions a pure function of the feed's seed, decision
        latency = the window's compute wall time.  ``realtime=True``
        paces arrivals at ``feed.frame_rate_hz`` on a producer thread
        through the drop-oldest ring; decision latency then includes real
        queueing, and a trigger slower than the feed *loses frames*
        (reported, never blocking the producer).
        """
        report = TriggerReport(backend=self.backend, fmt=self.fmt,
                               window=self.window, realtime=realtime,
                               frames=n_frames, warmup_s=self.warmup_s,
                               deadline_us=self.budget.max_latency_us
                               if self.budget is not None else None)
        if realtime:
            self._run_realtime(feed, n_frames, report)
        else:
            self._run_deterministic(feed, n_frames, report)
        lat = [d.latency_us for d in report.decisions]
        pct = percentiles(lat)
        report.p50_us = pct["p50"]
        report.p95_us = pct["p95"]
        report.p99_us = pct["p99"]
        report.max_us = max(lat, default=0.0)
        if report.wall_s > 0:
            report.sustained_fps = report.processed / report.wall_s
        return report

    def _run_deterministic(self, feed: DetectorFeed, n_frames: int,
                           report: TriggerReport) -> None:
        t_start = time.perf_counter()
        batch: list[Frame] = []
        for frame in feed.frames(n_frames):
            batch.append(frame)
            if len(batch) == self.window:
                t0 = time.perf_counter()
                self._decide(batch, len(batch), [t0] * len(batch), report)
                batch = []
        if batch:
            n_real = len(batch)
            t0 = time.perf_counter()
            self._decide(self._pad(batch), n_real, [t0] * n_real, report)
        report.wall_s = time.perf_counter() - t_start

    def _run_realtime(self, feed: DetectorFeed, n_frames: int,
                      report: TriggerReport) -> None:
        done = threading.Event()

        def produce():
            t0 = time.perf_counter()
            try:
                for frame in feed.frames(n_frames):
                    delay = frame.t_sched - (time.perf_counter() - t0)
                    if delay > 0:
                        time.sleep(delay)
                    frame.arrival_t = time.perf_counter()
                    self.ring.push(frame)
            finally:
                done.set()

        producer = threading.Thread(target=produce, name="detector-feed",
                                    daemon=True)
        t_start = time.perf_counter()
        producer.start()
        while True:
            frames = self.ring.pop_many(self.window)
            if not frames:
                if done.is_set() and not len(self.ring):
                    break
                time.sleep(1e-4)
                continue
            if len(frames) < self.window and not done.is_set():
                # partial window mid-stream: wait (bounded by the time the
                # feed needs to deliver the rest, plus slack) rather than
                # dispatching a padded window per straggler
                deadline = time.perf_counter() + \
                    (self.window - len(frames) + 1.0) / feed.frame_rate_hz
                while len(frames) < self.window and \
                        time.perf_counter() < deadline:
                    more = self.ring.pop_many(self.window - len(frames))
                    if more:
                        frames.extend(more)
                    else:
                        time.sleep(1e-4)
            n_real = len(frames)
            t_ref = [f.arrival_t for f in frames]
            if n_real < self.window:
                frames = self._pad(frames)
            self._decide(frames, n_real, t_ref, report)
        producer.join()
        report.wall_s = time.perf_counter() - t_start
        report.dropped = self.ring.dropped
