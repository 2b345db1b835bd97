"""The search loop: strategy x evaluator x budget -> persisted best config.

``Tuner.run()``:

  1. keys the ``TuningDB`` on (graph fingerprint, space hash) and — unless
     forced — serves a previous result whose budget already covers the
     request, *without re-searching*;
  2. evaluates the baseline (the space's default assignment) first, so
     every search result is comparable against the stock configuration;
  3. drives the strategy ask/tell until the candidate budget is spent or
     the strategy exhausts itself, deduping re-proposals through a trial
     cache (the design cache below makes those free anyway);
  4. picks the best *valid* trial (numerics gate in the evaluator), and
     persists baseline + best + the full trial log to the DB.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.core.pipeline import graph_fingerprint
from repro_torch.tune.db import TuningDB
from repro_torch.tune.evaluator import Evaluator, Trial
from repro_torch.tune.space import Candidate
from repro_torch.tune.strategies import Strategy


@dataclasses.dataclass
class TuneResult:
    """What a tuning run (or a DB hit) returns."""

    best: Trial
    baseline: Trial
    trials: list[Trial]
    design_fingerprint: str
    space_hash: str
    strategy: str
    budget: int
    from_db: bool
    wall_s: float

    @property
    def speedup(self) -> float:
        """Baseline latency / best latency (>= 1.0 when the search won)."""
        return (self.baseline.latency_us / self.best.latency_us
                if self.best.latency_us else 1.0)

    def summary(self) -> str:
        src = "tuning DB" if self.from_db else \
            f"{len(self.trials)} trials in {self.wall_s:.1f}s"
        if not self.best.valid:
            note = (" [NO candidate passed the numerics gate — baseline "
                    "shown]")
        elif not getattr(self.best, "feasible", True):
            note = (" [NO candidate fit the trigger budget — baseline "
                    "shown, over on "
                    f"{', '.join(self.best.budget_failures) or '?'}]")
        else:
            note = ""
        return (f"best of {src}: {self.best.latency_us:.2f} us/sample "
                f"(baseline {self.baseline.latency_us:.2f} us, "
                f"{self.speedup:.2f}x)  {self.best.candidate.label()}{note}")

    def to_entry(self) -> dict:
        return {
            "strategy": self.strategy,
            "budget": self.budget,
            "n_trials": len(self.trials),
            "wall_s": round(self.wall_s, 3),
            "baseline": self.baseline.to_json(),
            "best": self.best.to_json(),
            "trials": [t.to_json() for t in self.trials],
        }

    @classmethod
    def from_entry(cls, entry: dict, *, design_fingerprint: str,
                   space_hash: str) -> "TuneResult":
        trials = [Trial.from_json(t) for t in entry.get("trials", [])]
        return cls(
            best=Trial.from_json(entry["best"]),
            baseline=Trial.from_json(entry["baseline"]),
            trials=trials, design_fingerprint=design_fingerprint,
            space_hash=space_hash, strategy=entry.get("strategy", "?"),
            budget=int(entry.get("budget", len(trials))), from_db=True,
            wall_s=float(entry.get("wall_s", 0.0)))


class Tuner:
    """Drives one search; see the module docstring for the contract."""

    def __init__(self, evaluator: Evaluator, strategy: Strategy, *,
                 db: Optional[TuningDB] = None, budget: int = 16,
                 on_trial: Optional[Callable[[Trial], None]] = None):
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.evaluator = evaluator
        self.strategy = strategy
        self.db = db
        self.budget = budget
        self.on_trial = on_trial

    # -- helpers ------------------------------------------------------------

    @property
    def space(self):
        return self.evaluator.space

    def _identity(self) -> tuple[str, str]:
        return (graph_fingerprint(self.evaluator.graph),
                self.space.space_hash())

    def context(self) -> dict:
        """What makes this run an experiment of its own: the strategy, its
        parameters, and the evaluation settings.  Part of the DB key — two
        runs with different contexts never overwrite or serve each other.
        """
        return {"strategy": self.strategy.name,
                "params": self.strategy.params(),
                "eval": self.evaluator.settings()}

    def _context_hash(self) -> str:
        from repro_torch.tune.db import TuningDB
        return TuningDB.context_hash(self.context())

    def _serve_from_db(self) -> Optional[TuneResult]:
        if self.db is None:
            return None
        fp, sh = self._identity()
        entry = self.db.get(fp, sh, self._context_hash())
        if entry is None or int(entry.get("budget", 0)) < self.budget:
            return None
        return TuneResult.from_entry(entry, design_fingerprint=fp,
                                     space_hash=sh)

    # -- the loop -----------------------------------------------------------

    def run(self, *, force: bool = False) -> TuneResult:
        served = None if force else self._serve_from_db()
        if served is not None:
            return served

        t_start = time.perf_counter()
        trials: dict[Candidate, Trial] = {}

        def eval_once(c: Candidate) -> Trial:
            trial = trials.get(c)
            if trial is None:
                trial = self.evaluator.evaluate(c)
                trials[c] = trial
                if self.on_trial is not None:
                    self.on_trial(trial)
            return trial

        baseline_cand = self.space.default()
        baseline = eval_once(baseline_cand)
        self.strategy.reset(self.space, baseline_cand)
        self.strategy.observe(baseline_cand, baseline)

        # proposals are bounded: duplicates are served from the trial cache
        # and don't consume budget, but a strategy stuck re-proposing is
        # cut off rather than looping forever
        max_proposals = 50 * self.budget + 100
        proposals = 0
        while len(trials) < self.budget and proposals < max_proposals:
            proposals += 1
            cand = self.strategy.propose()
            if cand is None:
                break
            self.strategy.observe(cand, eval_once(cand))

        ranked = sorted((t for t in trials.values() if t.score() is not None),
                        key=Trial.score)
        best = ranked[0] if ranked else baseline
        result = TuneResult(
            best=best, baseline=baseline, trials=list(trials.values()),
            design_fingerprint=self._identity()[0],
            space_hash=self._identity()[1], strategy=self.strategy.name,
            budget=self.budget, from_db=False,
            wall_s=time.perf_counter() - t_start)

        if self.db is not None:
            fp, sh = self._identity()
            entry = result.to_entry()
            # single source of truth for the run's settings: the context
            # (strategy name/params + evaluator settings)
            entry["context"] = self.context()
            self.db.put(fp, sh, entry, self._context_hash())
        return result
