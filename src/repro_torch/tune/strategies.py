"""Search strategies over a ``SearchSpace``.

The protocol is ask/tell: the ``Tuner`` calls ``reset(space, baseline)``
once, then alternates ``propose() -> Candidate | None`` (``None`` = the
strategy is exhausted) with ``observe(candidate, trial)``.  Proposals the
tuner has already evaluated are answered from its trial cache — strategies
may re-propose freely without burning budget.

Three strategies ship:

  * ``Bisection``   — the paper's §4.2 discipline: bisect the ordered
    unroll-factor domain for the smallest capacity that still meets the
    latency target, then descend the precision ladder while the design
    stays numerically valid.
  * ``HillClimb``   — coordinate descent with full line search per knob;
    it automates the manual hypothesis -> change -> measure rounds.
  * ``RandomSearch``— uniform without replacement; the honesty baseline.

``sweep_variants`` is the generic tagged-variant sweep loop.

A copy of the reference package's ``tune.strategies``: the same seed gives
the same proposals.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.tune.space import PRECISION_KNOB, Candidate, SearchSpace


class Strategy:
    """Base ask/tell strategy.  Subclasses override all three hooks."""

    name = "base"

    def reset(self, space: SearchSpace, baseline: Candidate) -> None:
        self.space = space
        self.baseline = baseline

    def propose(self) -> Optional[Candidate]:
        raise NotImplementedError

    def observe(self, candidate: Candidate, trial) -> None:  # noqa: B027
        pass

    def params(self) -> dict:
        """The strategy's own parameters — part of the TuningDB run
        context, so e.g. bisection runs toward different targets never
        serve each other's results."""
        return {}


class RandomSearch(Strategy):
    """Uniform sampling without replacement (after the baseline)."""

    name = "random"

    def __init__(self, seed: int = 0, max_draws: int = 200):
        self.seed = seed
        self.max_draws = max_draws

    def params(self):
        return {"seed": self.seed}

    def reset(self, space, baseline):
        super().reset(space, baseline)
        self.rng = np.random.default_rng(self.seed)
        self.seen = {baseline}
        self.draws = 0

    def propose(self):
        while self.draws < self.max_draws:
            self.draws += 1
            c = self.space.random_candidate(self.rng)
            if c not in self.seen:
                self.seen.add(c)
                return c
        return None


class HillClimb(Strategy):
    """Coordinate descent: line-search one knob at a time from the best
    point so far; stop after a full sweep of all knobs without improvement.
    """

    name = "hillclimb"

    def __init__(self, max_sweeps: int = 4):
        self.max_sweeps = max_sweeps

    def params(self):
        return {"max_sweeps": self.max_sweeps}

    def reset(self, space, baseline):
        super().reset(space, baseline)
        self.best = baseline
        self.best_score = None
        self.pending: list[Candidate] = []
        self.knob_idx = -1
        self.improved = False
        self.sweeps = 0
        self.done = not space.knobs

    def _refill(self) -> bool:
        """Queue the line search for the next knob; False when finished."""
        while not self.pending:
            self.knob_idx += 1
            if self.knob_idx >= len(self.space.knobs):
                self.sweeps += 1
                if not self.improved or self.sweeps >= self.max_sweeps:
                    return False
                self.knob_idx = 0
                self.improved = False
            knob = self.space.knobs[self.knob_idx]
            cur = self.best.get(knob.name)
            self.pending = [self.best.replace(knob.name, v)
                            for v in knob.values if v != cur]
        return True

    def propose(self):
        if self.done:
            return None
        if not self._refill():
            self.done = True
            return None
        return self.pending.pop(0)

    def observe(self, candidate, trial):
        score = trial.score()
        if score is None:
            return
        if self.best_score is None and candidate == self.best:
            self.best_score = score
            return
        if self.best_score is None or score < self.best_score:
            self.best, self.best_score = candidate, score
            self.improved = True


class Bisection(Strategy):
    """OpenHLS-style bisection-to-latency-target (paper §4.2).

    Phase 1 bisects ``knob`` (default ``unroll_factor``; the domain is
    sorted by capacity, ``None`` = the design's own K = largest) for the
    *smallest* capacity whose schedule still meets ``target_us``.  When no
    target is given, the baseline's own latency is the target — i.e. find
    the cheapest design that is no slower than the default.  Phase 2 then
    walks the precision ladder in domain order, keeping each narrower
    format while the design stays numerically valid and on target.
    """

    name = "bisect"

    def __init__(self, target_us: Optional[float] = None,
                 knob: str = "unroll_factor"):
        self.target_us = target_us
        self.knob_name = knob

    def params(self):
        return {"target_us": self.target_us, "knob": self.knob_name}

    def reset(self, space, baseline):
        super().reset(space, baseline)
        knob = space.knob(self.knob_name)
        if knob is None:
            raise ValueError(
                f"Bisection needs a {self.knob_name!r} knob; space "
                f"{space.name!r} has {[k.name for k in space.knobs]}")
        # ascending capacity; None (full K) is the largest
        self.domain = sorted(
            knob.values, key=lambda v: float("inf") if v is None else v)
        self.lo, self.hi = 0, len(self.domain) - 1
        self.target = self.target_us
        self.feasible: Optional[Candidate] = None
        self.phase = "baseline" if self.target is None else "bisect"
        self.prec_values = ()
        prec = space.knob(PRECISION_KNOB)
        if prec is not None:
            base_val = baseline.get(PRECISION_KNOB)
            vals = list(prec.values)
            if base_val in vals:            # descend from the baseline on
                vals = vals[vals.index(base_val) + 1:]
            self.prec_values = tuple(vals)
        self.prec_idx = 0
        self.pending: Optional[Candidate] = None

    def _at(self, i: int) -> Candidate:
        return self.baseline.replace(self.knob_name, self.domain[i])

    def propose(self):
        if self.pending is not None:
            return self.pending            # waiting on an observe
        if self.phase == "baseline":
            self.pending = self.baseline
        elif self.phase == "bisect":
            if self.lo > self.hi:
                self.phase = "precision"
                return self.propose()
            self.mid = (self.lo + self.hi) // 2
            self.pending = self._at(self.mid)
        elif self.phase == "precision":
            if self.feasible is None or self.prec_idx >= len(self.prec_values):
                self.phase = "done"
                return None
            self.pending = self.feasible.replace(
                PRECISION_KNOB, self.prec_values[self.prec_idx])
        else:
            return None
        return self.pending

    def observe(self, candidate, trial):
        if candidate != self.pending:
            return
        self.pending = None
        if self.phase == "baseline":
            self.target = trial.latency_us
            self.feasible = candidate if trial.score() is not None else None
            self.phase = "bisect"
            return
        meets = trial.score() is not None and trial.latency_us <= self.target
        if self.phase == "bisect":
            if meets:
                self.feasible = candidate
                self.hi = self.mid - 1     # try a smaller capacity
            else:
                self.lo = self.mid + 1
        elif self.phase == "precision":
            if meets:
                self.feasible = candidate  # keep the narrower format
                self.prec_idx += 1
            else:
                self.phase = "done"        # ladder ends at first failure


STRATEGIES: dict[str, Callable[..., Strategy]] = {
    RandomSearch.name: RandomSearch,
    HillClimb.name: HillClimb,
    Bisection.name: Bisection,
}


def make_strategy(name: str, **kw) -> Strategy:
    if name not in STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"known: {sorted(STRATEGIES)}")
    return STRATEGIES[name](**kw)


# ---------------------------------------------------------------------------
# The generic tagged-variant sweep
# ---------------------------------------------------------------------------


def sweep_variants(variants: Sequence[tuple[str, object]],
                   evaluate: Callable[[str, object], object],
                   *, skip: Optional[Callable[[str, object], bool]] = None,
                   on_result: Optional[Callable[[str, object], None]] = None,
                   ) -> dict[str, object]:
    """Run ``evaluate(tag, payload)`` over ordered tagged variants.

    ``skip(tag, payload)`` short-circuits variants whose artifact already
    exists (a resumable sweep);
    skipped variants are not re-evaluated and do not appear in the result.
    """
    results: dict[str, object] = {}
    for tag, payload in variants:
        if skip is not None and skip(tag, payload):
            continue
        out = evaluate(tag, payload)
        results[tag] = out
        if on_result is not None:
            on_result(tag, out)
    return results
