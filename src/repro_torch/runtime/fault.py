"""Fault-tolerant training driver: watchdog, failure injection, restart.

The driver owns the production loop:
    pipeline.get(step) -> train_step -> metrics -> periodic async checkpoint

and layers three protections around it:

  * **checkpoint/restart** — on any step exception the driver restores the
    latest complete checkpoint, seeks the (seekable) data pipeline, and
    replays from there; bounded by ``max_restarts``.  Because both the
    pipeline and the optimizer are deterministic, a restarted run equals an
    uninterrupted one bit for bit (on the card, with deterministic cuDNN
    and cuBLAS).
  * **step watchdog** — steps slower than ``deadline_factor`` x the running
    median are recorded as stragglers.
  * **failure injection** — ``FailureInjector`` raises at configured steps,
    which the tests use to prove the restart path.

``FailureInjector`` and ``StepWatchdog`` use only the standard library:
:class:`repro_torch.serving.design_engine.DesignEngine` wires the same pair
around its dispatch loop, so a poisoned replica restarts from its saved
artifact with in-flight requests re-queued — the serving twin of the
checkpoint/restart discipline here.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.core import device as devices


class FailureInjector:
    """Raises RuntimeError at each step in ``fail_at`` exactly once.

    Shared by the training driver (step index) and the serving engines
    (dispatch index): both call ``check`` once per unit of work, so tests
    can poison a specific step/dispatch and assert the restart path.
    """

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.remaining = set(fail_at)
        self.fired: list[int] = []

    def check(self, step: int) -> None:
        if step in self.remaining:
            self.remaining.discard(step)
            self.fired.append(step)
            raise RuntimeError(f"injected failure at step {step}")


class StepWatchdog:
    """Flags steps slower than ``deadline_factor`` x the running median.

    The straggler detector both the training driver and the serving
    engines layer around their work loop: feed each step's wall time to
    :meth:`observe`; once ``min_history`` durations are recorded, a step
    beyond ``deadline_factor`` times the median of the last ``window``
    durations (including the current one) is recorded in ``stragglers``.
    On real pods this is the signal for preemptive re-scheduling /
    hot-spare promotion; here it is telemetry in the reports.
    """

    def __init__(self, deadline_factor: float = 3.0, *, window: int = 20,
                 min_history: int = 5):
        self.deadline_factor = deadline_factor
        self.window = window
        self.min_history = min_history
        self.durations: list[float] = []
        self.stragglers: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        """Record one step duration; True when it is a straggler."""
        self.durations.append(dt)
        if len(self.durations) >= self.min_history:
            med = statistics.median(self.durations[-self.window:])
            if dt > self.deadline_factor * med:
                self.stragglers.append(step)
                return True
        return False


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    checkpoint_every: int = 10
    max_restarts: int = 3
    deadline_factor: float = 3.0


@dataclasses.dataclass
class DriverReport:
    steps_run: int
    restarts: int
    straggler_steps: list
    final_metrics: dict
    losses: list


class TrainingDriver:
    """Runs ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for ``cfg.total_steps`` steps with checkpoint/restart.

    ``pipeline`` is any seekable source of batches: ``seek(step)``,
    ``get(step)`` and ``stop()`` (a
    :class:`repro_torch.data.SyntheticTokenPipeline`, or one of peaks).
    ``metrics["loss"]`` is a scalar tensor or a number; the step's device
    work is waited for before its time is taken.  A failure before the
    first checkpoint restarts from the ``params`` and ``opt_state`` given
    to :meth:`run`; a ``train_step`` that writes its inputs in place (its
    ``in_place`` attribute is true, as ``launch.steps.make_train_step``'s
    is) has them checkpointed at step 0 first, since its steps overwrite
    them.
    """

    def __init__(self, cfg: DriverConfig, *, train_step: Callable,
                 pipeline: Any, ckpt: CheckpointManager,
                 injector: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.injector = injector or FailureInjector()

    def run(self, params: Any, opt_state: Any) -> DriverReport:
        state = initial = {"params": params, "opt": opt_state}
        start_step = 0
        restarts = 0
        losses: list[float] = []
        watchdog = StepWatchdog(self.cfg.deadline_factor)
        metrics: dict = {}
        if getattr(self.train_step, "in_place", False):
            self.ckpt.save(0, state)

        while True:
            try:
                self.pipeline.seek(start_step)
                step = start_step
                while step < self.cfg.total_steps:
                    t0 = time.monotonic()
                    batch = self.pipeline.get(step)
                    self.injector.check(step)
                    new_params, new_opt, metrics = self.train_step(
                        state["params"], state["opt"], batch)
                    loss = metrics["loss"]
                    if isinstance(loss, torch.Tensor):
                        devices.synchronize(loss.device)
                    state = {"params": new_params, "opt": new_opt}
                    losses.append(float(loss))
                    watchdog.observe(step, time.monotonic() - t0)
                    step += 1
                    if step % self.cfg.checkpoint_every == 0:
                        self.ckpt.save_async(step, state)
                self.ckpt.wait()
                self.ckpt.save(self.cfg.total_steps, state)
                break
            except Exception:
                # the restart boundary: any step failure is retried from
                # the latest checkpoint, up to max_restarts, then re-raised
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    # restart from scratch: the state the run began with
                    # (a functional update left it intact)
                    state, start_step = initial, 0
                else:
                    state, start_step = (
                        self.ckpt.restore(state, latest)[0], latest)
        self.pipeline.stop()
        return DriverReport(steps_run=self.cfg.total_steps,
                            restarts=restarts,
                            straggler_steps=watchdog.stragglers,
                            final_metrics={k: float(v)
                                           for k, v in metrics.items()},
                            losses=losses)
