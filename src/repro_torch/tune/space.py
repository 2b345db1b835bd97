"""Declarative design spaces for the OpenHLS flow.

A ``SearchSpace`` names a set of *knobs*, each with a finite ordered domain.
Three families of knobs exist, mirroring the levers the paper actually
searched over (§4.2: bisection over unroll factors, precision stepping
(5,11) -> (5,4) -> (5,3)) and the ones hls4ml exposes as reuse-factor /
strategy:

  * **pass-pipeline knobs** — which registered passes run, in what order
    (``pipeline``), plus pass options (``tree_threshold``, ``max_rounds``);
  * **schedule knobs** — any field of ``core.schedule.ScheduleParams``
    (``unroll_factor``, ``binding``, ``pipelined_units``, ``alap_compact``,
    ``ports_per_array``, ``n_stages``);
  * **precision** — the FloPoCo (wE, wF) functional-model format the design
    is validated and deployed at (``"fp32"`` = no quantisation).

A ``Candidate`` is one assignment over the knobs.  It is hashable (the
tuner dedupes on it), JSON round-trippable (the ``TuningDB`` persists it),
and lowers to a ``CompilerConfig`` + optional ``FloatFormat`` via the
space.  The first value of every knob domain is, by convention, the
*baseline* — ``SearchSpace.default()`` is the config every search is
measured against.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Iterator, Optional

from repro_torch.core.cachedir import CACHE_FORMAT_VERSION
from repro_torch.core.pipeline import (DEFAULT_PIPELINE, PASS_REGISTRY,
                                 CompilerConfig)
from repro_torch.core.precision import FORMATS, FloatFormat

#: Knob names that map 1:1 onto ``CompilerConfig`` fields.
CONFIG_KNOBS = ("pipeline", "tree_threshold", "max_rounds", "binding",
                "unroll_factor", "ports_per_array", "pipelined_units",
                "alap_compact", "n_stages")
#: The knob interpreted as a FloPoCo format key (``precision.FORMATS``).
PRECISION_KNOB = "precision"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One searchable parameter: a name and its finite, ordered domain.

    ``values[0]`` is the baseline.  Order is meaningful to strategies:
    ``Bisection`` bisects the domain as given, and precision domains are
    conventionally widest-first (the paper's (5,11) -> (5,3) descent).
    """

    name: str
    values: tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"knob {self.name!r} has an empty domain")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"knob {self.name!r} has duplicate values")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of a search space: a (knob -> value) assignment.

    Stored as sorted items so equal assignments hash equally regardless of
    construction order.
    """

    items: tuple[tuple[str, Any], ...]

    @classmethod
    def of(cls, assignment: dict[str, Any]) -> "Candidate":
        return cls(tuple(sorted(assignment.items())))

    def get(self, name: str, default: Any = None) -> Any:
        for k, v in self.items:
            if k == name:
                return v
        return default

    def replace(self, name: str, value: Any) -> "Candidate":
        d = dict(self.items)
        d[name] = value
        return Candidate.of(d)

    def to_json(self) -> dict[str, Any]:
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in self.items}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Candidate":
        return cls.of({k: tuple(v) if isinstance(v, list) else v
                       for k, v in d.items()})

    def label(self) -> str:
        """Compact human-readable tag, e.g. ``unroll=64,precision=5_4``."""
        parts = []
        for k, v in self.items:
            if k == "pipeline":
                v = "+".join(v) if v else "none"
            parts.append(f"{k}={v}")
        return ",".join(parts)

    def __str__(self) -> str:
        return self.label()


class SearchSpace:
    """A named set of knobs over a base ``CompilerConfig``."""

    def __init__(self, knobs: tuple[Knob, ...] = (), *,
                 base: Optional[CompilerConfig] = None, name: str = "space"):
        names = [k.name for k in knobs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate knob names in {names}")
        for k in knobs:
            if k.name not in CONFIG_KNOBS and k.name != PRECISION_KNOB:
                raise ValueError(
                    f"unknown knob {k.name!r}; config knobs: {CONFIG_KNOBS}, "
                    f"or {PRECISION_KNOB!r}")
            if k.name == "pipeline":
                for pipe in k.values:
                    unknown = [p for p in pipe if p not in PASS_REGISTRY]
                    if unknown:
                        raise ValueError(f"pipeline variant {pipe} names "
                                         f"unregistered pass {unknown[0]!r}")
            if k.name == PRECISION_KNOB:
                bad = [v for v in k.values
                       if v != "fp32" and v not in FORMATS]
                if bad:
                    raise ValueError(f"unknown precision key {bad[0]!r}; "
                                     f"known: fp32, {sorted(FORMATS)}")
        self.knobs = tuple(knobs)
        self.base = base or CompilerConfig()
        self.name = name

    # -- candidates ---------------------------------------------------------

    def default(self) -> Candidate:
        """The baseline: every knob at the first value of its domain."""
        return Candidate.of({k.name: k.values[0] for k in self.knobs})

    def knob(self, name: str) -> Optional[Knob]:
        for k in self.knobs:
            if k.name == name:
                return k
        return None

    def contains(self, c: Candidate) -> bool:
        if {k for k, _ in c.items} != {k.name for k in self.knobs}:
            return False
        return all(c.get(k.name) in k.values for k in self.knobs)

    def size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    def enumerate(self) -> Iterator[Candidate]:
        """All candidates, baseline-first lexicographic in knob order."""
        def rec(i: int, acc: dict):
            if i == len(self.knobs):
                yield Candidate.of(acc)
                return
            k = self.knobs[i]
            for v in k.values:
                acc[k.name] = v
                yield from rec(i + 1, acc)
            del acc[k.name]
        yield from rec(0, {})

    def random_candidate(self, rng) -> Candidate:
        """One uniform sample (``rng``: ``numpy.random.Generator``)."""
        return Candidate.of({
            k.name: k.values[int(rng.integers(len(k.values)))]
            for k in self.knobs})

    # -- lowering -----------------------------------------------------------

    def to_config(self, c: Candidate) -> CompilerConfig:
        """Lower a candidate onto the base ``CompilerConfig``."""
        over = {k: v for k, v in c.items if k in CONFIG_KNOBS}
        return dataclasses.replace(self.base, **over)

    def to_format(self, c: Candidate) -> Optional[FloatFormat]:
        key = c.get(PRECISION_KNOB, "fp32")
        return None if key in (None, "fp32") else FORMATS[key]

    # -- identity -----------------------------------------------------------

    def space_hash(self) -> str:
        """Content hash of the space definition: knob domains + base config.

        Keys the ``TuningDB`` together with the design's graph fingerprint,
        so a changed domain (or cache-format bump) never serves stale
        tuning results.
        """
        h = hashlib.sha256()
        h.update(f"v{CACHE_FORMAT_VERSION}|{self.name}|".encode())
        for k in self.knobs:
            h.update(f"{k.name}:{k.values!r};".encode())
        h.update(self.base.key().encode())
        return h.hexdigest()

    def describe(self) -> str:
        lines = [f"space {self.name!r} ({self.size()} candidates):"]
        for k in self.knobs:
            lines.append(f"  {k.name:16s} {list(k.values)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Stock spaces
# ---------------------------------------------------------------------------


def braggnn_space(*, base: Optional[CompilerConfig] = None) -> SearchSpace:
    """The BraggNN design space (paper §4.2's knobs, plus hls4ml's).

    Baselines reproduce the paper's deployment: the default §3.2 pass
    pipeline, full-capacity pool binding, a 3-stage pipeline, and the
    (5,11) half-precision starting point of the precision descent.
    """
    no_tree = tuple(p for p in DEFAULT_PIPELINE if p != "reduction_tree")
    return SearchSpace((
        Knob("pipeline", (DEFAULT_PIPELINE, no_tree, ("cse", "dce"))),
        Knob("tree_threshold", (4, 2, 8)),
        Knob("unroll_factor", (None, 2048, 512, 128, 32)),
        Knob("pipelined_units", (False, True)),
        Knob("alap_compact", (True, False)),
        Knob("n_stages", (3, 1, 4)),
        Knob(PRECISION_KNOB, ("5_11", "5_4", "5_3")),
    ), base=base or CompilerConfig(n_stages=3), name="braggnn")


def conv2d_space(*, base: Optional[CompilerConfig] = None) -> SearchSpace:
    """A small space for single-layer designs (and fast smoke tests)."""
    return SearchSpace((
        Knob("pipeline", (DEFAULT_PIPELINE, ("cse", "dce"))),
        Knob("unroll_factor", (None, 16, 4)),
        Knob("pipelined_units", (False, True)),
        Knob(PRECISION_KNOB, ("fp32", "5_4")),
    ), base=base, name="conv2d")


def trigger_space(*, base: Optional[CompilerConfig] = None) -> SearchSpace:
    """The deployment-envelope space for trigger tuning.

    An unroll/stage ladder that trades DSP pressure against latency:
    full-capacity unrolling is the fastest schedule but the heaviest
    footprint, so it is exactly the knob a part-level resource cap
    (``Design.tune(..., budget=TriggerBudget(part=...))``) bites on —
    under a tight DSP cap the winner slides down the ladder to the
    fastest *feasible* rung.
    """
    return SearchSpace((
        Knob("pipeline", (DEFAULT_PIPELINE, ("cse", "dce"))),
        Knob("unroll_factor", (None, 1024, 256, 64, 16, 4)),
        Knob("pipelined_units", (True, False)),
        Knob("n_stages", (3, 1)),
    ), base=base, name="trigger")
