"""Failure injection and the straggler watchdog of the serving engine.

``FailureInjector`` raises at chosen units of work and ``StepWatchdog``
flags slow ones.  :class:`repro_torch.serving.design_engine.DesignEngine`
wires the pair around its dispatch loop: a poisoned replica restarts from
its saved artifact with in-flight requests re-queued.  Both use only the
standard library; the training driver that shares them in the reference
comes with the port's training slice.
"""

from __future__ import annotations

import statistics


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
