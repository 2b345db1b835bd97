"""Hard-real-time streaming trigger: budgets, parts, and the stream loop.

OpenHLS exists for the data-acquisition trigger setting — a fixed
µs-scale latency budget, streaming sensor input, no host in the loop.
This package makes that setting first-class instead of folklore:

  * :mod:`repro_torch.trigger.parts` — a catalog of named FPGA parts
    (:data:`alveo_u280`, :data:`zcu102`, synthetic :func:`part`) whose
    resource pools speak the same vocabulary as
    ``Schedule.resources()``;
  * :mod:`repro_torch.trigger.budget` — :class:`TriggerBudget` (max latency
    µs, max II, per-resource caps with headroom margins) and
    :func:`check_design` producing a structured :class:`BudgetReport`
    (``Design.check_budget`` / ``Design.report(budget=...)`` are the
    front doors; ``tune`` uses the same check as a feasibility gate);
  * :mod:`repro_torch.trigger.stream` — :class:`DetectorFeed` (seeded
    Bragg-peak frames with pileup bursts), the drop-oldest ring, and
    :class:`TriggerLoop` emitting accept/reject decisions with
    per-window deadline accounting on any emission backend.

Quickstart::

    from repro_torch import hls, trigger

    design = hls.compile(braggnn.bind(params), x)
    budget = trigger.TriggerBudget(max_latency_us=75.0, max_ii=4,
                                   part="alveo_u280", margin=0.1)
    design.check_budget(budget=budget).raise_if_failed()

    loop = trigger.TriggerLoop(design, budget=budget, backend="cuda")
    report = loop.run(trigger.DetectorFeed(img=11, frame_rate_hz=2000),
                      n_frames=1000, realtime=True)
    print(report.summary())     # sustained fps, miss %, drop %, p99 µs

On the card the loop's window shape is one captured CUDA graph, replayed
per window; ``device="cpu"`` runs the kernels' plain versions.
"""

from repro_torch.trigger.budget import (BudgetCheck, BudgetError, BudgetReport,
                                  TriggerBudget, check_design)
from repro_torch.trigger.parts import (PARTS, Part, alveo_u280, get_part, part,
                                 zcu102)
from repro_torch.trigger.stream import (DetectorFeed, Frame, TriggerDecision,
                                  TriggerLoop, TriggerReport,
                                  threshold_predicate)

__all__ = [
    "Part", "PARTS", "alveo_u280", "zcu102", "part", "get_part",
    "TriggerBudget", "BudgetCheck", "BudgetReport", "BudgetError",
    "check_design",
    "DetectorFeed", "Frame", "TriggerDecision", "TriggerLoop",
    "TriggerReport", "threshold_predicate",
]
