"""``repro_torch.tune`` — design-space exploration over the OpenHLS flow.

The paper reaches its 4.8 us/sample BraggNN latency by *searching*:
bisection over unroll factors and a precision descent until the target is
met (§4.2); hls4ml ships the same idea as reuse-factor/strategy knobs.
This subsystem makes that search a first-class, persistent artifact on top
of the ``CompilerDriver``:

  * :mod:`repro_torch.tune.space`      — declarative ``SearchSpace`` (pass
    pipelines, ``ScheduleParams`` knobs, FloPoCo precision ladder);
  * :mod:`repro_torch.tune.evaluator`  — cached compile +
    interpreter-reference numerics gate + latency objective (the DFG tier timed on the card in
    measure mode, or the H100 roofline cost model in dry mode);
  * :mod:`repro_torch.tune.strategies` — ``Bisection`` (paper-style),
    ``HillClimb`` (coordinate descent),
    ``RandomSearch``;
  * :mod:`repro_torch.tune.db`         — ``TuningDB``: best configs persisted
    under the port's versioned cache root, keyed by
    (design content hash, space hash);
  * :mod:`repro_torch.tune.tuner`      — the budgeted ask/tell loop;
  * ``python -m repro_torch.tune``     — the CLI
    (:mod:`repro_torch.tune.cli`).

Serving picks up wins via :func:`best_config_for`, through
``Design.apply_tuned`` and ``hls.compile(model, tuned=space)``.
"""

from typing import Optional

from repro_torch.tune.db import TuningDB, lookup_best
from repro_torch.tune.evaluator import Evaluator, Trial, roofline_estimate_us
from repro_torch.tune.space import (Candidate, Knob, SearchSpace,
                                    braggnn_space, conv2d_space,
                                    trigger_space)
from repro_torch.tune.strategies import (STRATEGIES, Bisection, HillClimb,
                                   RandomSearch, Strategy, make_strategy,
                                   sweep_variants)
from repro_torch.tune.tuner import TuneResult, Tuner

__all__ = [
    "TuningDB", "lookup_best", "Evaluator", "Trial", "roofline_estimate_us",
    "Candidate", "Knob", "SearchSpace", "braggnn_space", "conv2d_space",
    "trigger_space",
    "STRATEGIES", "Bisection", "HillClimb", "RandomSearch", "Strategy",
    "make_strategy", "sweep_variants", "TuneResult", "Tuner",
    "best_config_for",
]


def best_config_for(graph, space: SearchSpace, *,
                    db: Optional[TuningDB] = None):
    """The best-known ``(CompilerConfig, Candidate)`` for a traced design.

    Looks the (graph fingerprint, space hash) pair up in the ``TuningDB``;
    returns ``None`` when nothing has been tuned yet.  This is the hook
    serving and benchmarks use to auto-load tuned configurations.
    """
    from repro_torch.core.pipeline import graph_fingerprint
    assignment = lookup_best(db or TuningDB(), graph_fingerprint(graph),
                             space.space_hash())
    if assignment is None:
        return None
    candidate = Candidate.from_json(assignment)
    return space.to_config(candidate), candidate
