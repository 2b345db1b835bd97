"""Latency + resource budgets as first-class, checkable constraints.

The paper's 4.8 µs/sample BraggNN number is a *budget*, not just a
benchmark: a trigger design that misses the interval target or spills the
device's DSP pool does not deploy, full stop.  This module turns that
into structure:

  * :class:`TriggerBudget` — the envelope: max per-sample latency (µs),
    max initiation interval (intervals), and per-resource caps (explicit,
    or inherited from a named :class:`~repro_torch.trigger.parts.Part`);
  * :class:`BudgetReport` — the verdict of checking one compiled design
    against a budget: one :class:`BudgetCheck` row per constraint with
    used/cap/margin, ``passed``, and the *named* offending resources;
  * :func:`check_design` — reads ``schedule.resources()``, ``stage_ii``
    and ``sample_latency_us`` off a ``CompiledDesign`` (or the
    ``Design`` wrapper) and produces the report.

``Design.check_budget(...)`` and ``Design.report(budget=...)`` are the
front doors.  Nothing here imports torch: the check reads the schedule,
so it gives the reference's verdict for the same design.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.trigger.parts import Part, get_part

#: check-row kinds that are not device resource pools
_LATENCY = "latency_us"
_II = "stage_ii"


@dataclasses.dataclass(frozen=True)
class TriggerBudget:
    """One deployment envelope.

    ``max_latency_us`` bounds the scheduled per-sample decision latency
    (``CompiledDesign.sample_latency_us``: II x clock for pipelined
    designs, makespan x clock otherwise); ``max_ii`` bounds the stage
    initiation interval in raw intervals (an unpipelined design is
    checked on its makespan).  Resource caps come from ``part`` and can
    be tightened per pool (an explicit ``max_*`` always wins over the
    part's number).  ``margin`` demands fractional headroom on every
    resource pool: with ``margin=0.2`` a design may use at most 80% of
    each cap — latency/II caps are applied exactly, margins there belong
    in the number you pick.
    """

    max_latency_us: Optional[float] = None
    max_ii: Optional[int] = None
    part: Optional[Union[str, Part]] = None
    max_dsp: Optional[int] = None
    max_ff: Optional[int] = None
    max_bram_ports: Optional[int] = None
    max_lut: Optional[int] = None
    margin: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.margin < 1.0:
            raise ValueError(f"margin must be in [0, 1), got {self.margin}")
        # normalise part references eagerly so a typo fails at
        # construction, not at the first check
        object.__setattr__(self, "part", get_part(self.part))

    def resource_caps(self) -> dict[str, int]:
        """Merged per-resource caps (explicit ``max_*`` over the part)."""
        caps: dict[str, int] = dict(self.part.caps()) if self.part else {}
        for key, cap in (("DSP", self.max_dsp), ("FF", self.max_ff),
                         ("BRAM_ports", self.max_bram_ports),
                         ("LUT_units", self.max_lut)):
            if cap is not None:
                caps[key] = cap
        return caps

    def key(self) -> str:
        """Stable identity string (tuning-run context hashing)."""
        caps = ",".join(f"{k}={v}" for k, v in
                        sorted(self.resource_caps().items()))
        return (f"lat<={self.max_latency_us}|ii<={self.max_ii}|{caps}"
                f"|margin={self.margin}")

    def describe(self) -> str:
        bits = []
        if self.max_latency_us is not None:
            bits.append(f"latency <= {self.max_latency_us:g} us")
        if self.max_ii is not None:
            bits.append(f"II <= {self.max_ii}")
        if self.part is not None:
            bits.append(f"part {self.part.name}")
        over = {k: v for k, v in self.resource_caps().items()
                if self.part is None or self.part.caps().get(k) != v}
        if over:
            bits.append(", ".join(f"{k} <= {v:,}" for k, v in over.items()))
        if self.margin:
            bits.append(f"{self.margin:.0%} headroom")
        return "; ".join(bits) or "(unconstrained)"


@dataclasses.dataclass(frozen=True)
class BudgetCheck:
    """One constraint row: what the design uses vs what the budget allows.

    ``cap`` is the *effective* cap (resource margins already applied).
    """

    name: str
    used: float
    cap: float
    ok: bool

    @property
    def slack(self) -> float:
        return self.cap - self.used

    @property
    def utilisation(self) -> float:
        return self.used / self.cap if self.cap else float("inf")

    def summary(self) -> str:
        tag = "ok  " if self.ok else "FAIL"
        return (f"[{tag}] {self.name:10s} {self.used:>12,.6g} / "
                f"{self.cap:<12,.6g} ({self.utilisation:.1%} of cap, "
                f"slack {self.slack:,.6g})")


@dataclasses.dataclass
class BudgetReport:
    """The structured pass/fail verdict of one design-vs-budget check."""

    design: str
    budget: TriggerBudget
    checks: list[BudgetCheck]

    @property
    def passed(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failures(self) -> list[str]:
        """Names of every violated constraint (``DSP``, ``latency_us``...)."""
        return [c.name for c in self.checks if not c.ok]

    def check(self, name: str) -> Optional[BudgetCheck]:
        for c in self.checks:
            if c.name == name:
                return c
        return None

    def summary(self) -> str:
        verdict = "PASS" if self.passed else \
            f"FAIL ({', '.join(self.failures)} over budget)"
        lines = [f"budget check [{verdict}] {self.design} vs "
                 f"{self.budget.describe()}"]
        lines += [f"  {c.summary()}" for c in self.checks]
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "design": self.design,
            "passed": self.passed,
            "failures": self.failures,
            "budget": self.budget.key(),
            "part": self.budget.part.name if self.budget.part else None,
            "checks": [{"name": c.name, "used": c.used, "cap": c.cap,
                        "ok": c.ok, "slack": c.slack,
                        "utilisation": round(c.utilisation, 4)}
                       for c in self.checks],
        }

    def raise_if_failed(self) -> "BudgetReport":
        """Hard-gate form: raises ``BudgetError`` naming the offenders."""
        if not self.passed:
            raise BudgetError(self)
        return self


class BudgetError(RuntimeError):
    """A design blew its trigger budget (carries the full report)."""

    def __init__(self, report: BudgetReport):
        self.report = report
        super().__init__(report.summary())


def check_design(design, budget: Optional[TriggerBudget] = None, *,
                 part: Optional[Union[str, Part]] = None) -> BudgetReport:
    """Check one compiled design against a budget -> :class:`BudgetReport`.

    ``design`` is anything with ``schedule.resources()``, ``stage_ii``,
    ``sample_latency_us``, ``makespan`` and ``name`` — a
    ``CompiledDesign`` or the ``repro_torch.hls.Design`` wrapper.  ``part``
    is shorthand for a resource-caps-only budget; when both are given
    the part overrides the budget's own (so one budget template can be
    checked against several devices).
    """
    if budget is None and part is None:
        raise ValueError("give a TriggerBudget, a part, or both")
    if budget is None:
        budget = TriggerBudget(part=part)
    elif part is not None:
        budget = dataclasses.replace(budget, part=get_part(part))

    checks: list[BudgetCheck] = []
    if budget.max_latency_us is not None:
        used = float(design.sample_latency_us)
        checks.append(BudgetCheck(_LATENCY, used, float(budget.max_latency_us),
                                  used <= budget.max_latency_us))
    if budget.max_ii is not None:
        ii = design.stage_ii if design.stage_ii is not None \
            else design.makespan
        checks.append(BudgetCheck(_II, float(ii), float(budget.max_ii),
                                  ii <= budget.max_ii))
    used_res = design.schedule.resources()
    scale = 1.0 - budget.margin
    for name, cap in sorted(budget.resource_caps().items()):
        used = float(used_res.get(name, 0))
        eff = cap * scale
        checks.append(BudgetCheck(name, used, eff, used <= eff))
    return BudgetReport(design=design.name, budget=budget, checks=checks)
