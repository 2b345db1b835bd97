"""Candidate evaluation: compile (cached), validate numerics, cost latency.

Every candidate accepted by the tuner passes through three gates here:

  1. **compile** — through ``CompilerDriver`` and its design cache, so a
     re-proposed candidate (or a rerun of the whole search) is free; the
     driver's pass-stage memo additionally lets candidates that differ only
     in schedule knobs share one pass-pipeline run.
  2. **numerics** — the candidate's optimised graph is functionally
     simulated (at the candidate's FloPoCo format, if any) and compared
     against the *interpreter reference*: the raw traced DFG evaluated in
     fp32, i.e. the symbolic-interpretation semantics of ``core.interp``.
     Candidates outside tolerance are marked invalid and can never win.
  3. **latency** — the objective.  The primary metric is the scheduled
     design's per-sample latency (initiation interval x 10 ns for
     stage-pipelined designs, else makespan x 10 ns — the paper's interval
     counts), so the winner does not depend on the machine the search ran
     on.  In ``measure`` mode the design's default ``cuda`` runner — the
     generic DFG tier, one DFG-segment kernel launch per batch — is
     additionally timed on the card, replayed from its captured CUDA graph
     between CUDA events (with ``device="cpu"``, which tests ask for, the
     kernels' plain versions under ``perf_counter``); in ``--dry`` mode a
     roofline cost model (``launch.roofline``: the H100's constants)
     estimates that path instead.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import device as devices
from repro_torch.core import emit, verify
from repro_torch.core.interp import Context
from repro_torch.core.ir import Graph
from repro_torch.core.ir import OPCODES as ir_OPCODES
from repro_torch.core.pipeline import CompiledDesign, CompilerDriver
from repro_torch.tune.space import Candidate, SearchSpace

#: FLOPs per opcode (fmac counts two) for the roofline estimate, as a dense
#: per-opcode-id lookup aligned with ``ir.OPCODES``.  (The historical table
#: keyed on resource-class-style names — "add", "mul" — which never matched
#: the actual "addf"/"mulf" opcodes, so plain adds and muls were costed 0.)
_FLOPS_BY_NAME = {"addf": 1, "subf": 1, "mulf": 1, "divf": 1, "sqrtf": 1,
                  "fmac": 2, "maxf": 1, "minf": 1, "cmpugt": 1, "negf": 1,
                  "relu": 1, "select": 1}
_FLOPS_TABLE = np.array([_FLOPS_BY_NAME.get(name, 0) for name in ir_OPCODES],
                        dtype=np.int64)


@dataclasses.dataclass
class Trial:
    """The full record of one evaluated candidate."""

    candidate: Candidate
    design_hash: str
    latency_us: float             # objective: scheduled per-sample latency
    makespan: int
    stage_ii: Optional[int]
    err: float                    # vs the interpreter reference
    valid: bool                   # within tolerance -> eligible to win
    resources: dict[str, int]
    wire_bits: int                # per-value wire width at this precision
    #: Roofline-model estimate of the emitted DFG path on the card the port
    #: serves on (H100 constants from ``launch.roofline``) — a bound, not
    #: a prediction; compare roofline-to-roofline only.
    est_roofline_us: float
    #: us per sample of the DFG tier, timed on the evaluator's device
    #: (measure mode only; the run context names the device)
    measured_us: Optional[float]
    compile_s: float
    cached: bool                  # design served from the design cache
    #: trigger-budget gate verdict (True when no budget was configured);
    #: an infeasible candidate scores ``None`` and can never win
    feasible: bool = True
    #: the named constraints the candidate blew (``DSP``, ``latency_us``...)
    budget_failures: list = dataclasses.field(default_factory=list)

    def score(self) -> Optional[tuple]:
        """Ordering key: lower is better; ``None`` = ineligible.

        Latency first, then DSP units, then wire bits (the SLL-crossing
        pressure that forced the paper's (5,4) -> (5,3) step).  Both
        gates bite here: numerics-invalid and budget-infeasible trials
        are ineligible.
        """
        if not self.valid or not self.feasible:
            return None
        return (self.latency_us, self.resources.get("DSP", 0),
                self.wire_bits)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["candidate"] = self.candidate.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Trial":
        # tolerate schema drift (the DB's version gate discards truly
        # incompatible files; this guards same-version additive changes)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d["candidate"] = Candidate.from_json(d["candidate"])
        return cls(**d)

    def summary(self) -> str:
        tag = ("ok" if self.valid and self.feasible
               else "INVALID" if not self.valid
               else f"OVER BUDGET ({', '.join(self.budget_failures)})")
        meas = (f", measured={self.measured_us:.2f}us"
                if self.measured_us is not None else "")
        return (f"[{tag}] {self.latency_us:8.2f} us  "
                f"(makespan={self.makespan}, ii={self.stage_ii}, "
                f"err={self.err:.2e}, dsp={self.resources.get('DSP', 0)}"
                f"{meas})  {self.candidate.label()}")


def roofline_estimate_us(design: CompiledDesign) -> float:
    """Roofline cost model of the emitted DFG path (``--dry`` mode).

    max(compute term, memory term) over the optimised DFG, using the
    ``launch.roofline`` machine constants (one H100's fp32 rate and HBM
    bandwidth — so this bounds the card's path, not the local CPU): each
    arithmetic op is one FLOP (fmac: two) and every SSA value crosses
    memory once at 4 bytes.
    """
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    g = design.graph_opt
    flops = int(_FLOPS_TABLE[g.cols().opcode].sum())
    bytes_moved = 4.0 * g.n_values
    return max(flops / PEAK_FLOPS, bytes_moved / HBM_BW) * 1e6


class Evaluator:
    """Compile + validate + cost one candidate at a time.

    ``program`` is either a build callable (traced once, here) or an
    already-traced ``Graph`` — the trace is *shared* across all candidates,
    so per-candidate cost is passes + schedule only (and just schedule when
    the pass-stage memo hits).

    tolerances:
        ``tol_abs`` gates fp32 candidates (reassociation-level error);
        ``tol_rel`` gates quantised candidates on max relative error
        against the fp32 interpreter reference.

    ``budget`` (a :class:`repro_torch.trigger.TriggerBudget`) adds the trigger
    feasibility gate: every candidate's compiled schedule is checked
    against the envelope and an over-budget trial is marked infeasible —
    ineligible to win, exactly like a numerics-invalid one.

    ``device`` is where measure mode times the design: ``"cuda"`` (the
    default, which raises without a card) or ``"cpu"``.  Dry mode runs
    nothing on it.
    """

    def __init__(self, program: Union[Graph, "BuildFn"], space: SearchSpace,
                 *, driver: Optional[CompilerDriver] = None,
                 name: str = "design", batch: int = 2, seed: int = 0,
                 scale: float = 0.4, tol_abs: float = 1e-3,
                 tol_rel: float = 5e-2, measure: bool = False,
                 measure_reps: int = 5, budget=None, device=None):
        self.driver = driver or CompilerDriver()
        self.space = space
        self.name = name
        self.tol_abs = tol_abs
        self.tol_rel = tol_rel
        self.measure = measure
        self.measure_reps = measure_reps
        self.budget = budget
        self.device = devices.resolve(device) if measure else None
        self.batch = batch
        self.seed = seed
        self.scale = scale
        if isinstance(program, Graph):
            self.graph = program
        else:
            ctx = Context(forward=space.base.forward)
            program(ctx)
            self.graph = ctx.finalize()
        self.feeds = verify.random_feeds(self.graph, batch=batch, seed=seed,
                                         scale=scale)
        # the interpreter reference: raw traced DFG, fp32 — computed once
        self.ref = emit.evaluate(self.graph, self.feeds)
        self._ref_denom = max(
            (float(np.abs(v).max()) for v in self.ref.values()),
            default=0.0) + 1e-9
        # numerics depend only on (optimised graph, format): memoise
        self._err_memo: dict[tuple[str, str], float] = {}
        self._measure_memo: dict[str, float] = {}
        self.n_evals = 0

    def settings(self) -> dict:
        """Everything that shapes a trial besides the candidate itself.

        Stored with each ``TuningDB`` entry: a rerun is only served from
        the DB when its evaluation settings match — a different feed
        scale, tolerance, or measure mode is a different experiment.
        """
        return {"batch": self.batch, "seed": self.seed, "scale": self.scale,
                "tol_abs": self.tol_abs, "tol_rel": self.tol_rel,
                "mode": "measure" if self.measure else "dry",
                "device": self.device_name(),
                "budget": self.budget.key() if self.budget is not None
                else None}

    # -- gates --------------------------------------------------------------

    def _numeric_err(self, design: CompiledDesign, fmt) -> float:
        key = (design.config.pass_key(), str(fmt) if fmt else "fp32")
        err = self._err_memo.get(key)
        if err is None:
            out = emit.evaluate(design.graph_opt, self.feeds, fmt=fmt)
            err = max(float(np.abs(out[k] - self.ref[k]).max())
                      for k in self.ref)
            self._err_memo[key] = err
        return err

    def device_name(self) -> Optional[str]:
        """The device measure mode times on (the card's name), or None in
        dry mode."""
        if self.device is None:
            return None
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def _measure_us(self, design: CompiledDesign) -> float:
        """Time the design's default ``cuda`` runner (us per sample).

        A traced ``Graph`` has no ``ModuleGraph``, so that runner is the
        generic DFG tier: one DFG-segment kernel launch per batch.  On the
        card the feeds move to the device once, the first call captures
        the batch's CUDA graph, and each of ``measure_reps`` replays is
        timed between CUDA events (the median); on the CPU the plain
        versions are timed with ``perf_counter``.  Memoised on the pass
        key — the emitted function depends only on the optimised graph,
        never on the schedule knobs.
        """
        key = design.config.pass_key()
        cached = self._measure_memo.get(key)
        if cached is not None:
            return cached
        from repro_torch.core.graphs import GraphRunner
        dev = self.device
        fn = design.torch_fn(backend="cuda", device=dev)
        feeds = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                 for k, v in self.feeds.items()}
        run = GraphRunner(fn, dev)
        run(feeds)                                  # build, warm, capture
        times = []
        for _ in range(self.measure_reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(feeds)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)
            else:
                t0 = time.perf_counter()
                run(feeds)
                times.append((time.perf_counter() - t0) * 1e6)
        run.release()
        us = statistics.median(times) / self.batch
        self._measure_memo[key] = us
        return us

    # -- the evaluation -----------------------------------------------------

    def evaluate(self, candidate: Candidate) -> Trial:
        cfg = self.space.to_config(candidate)
        fmt = self.space.to_format(candidate)

        misses = self.driver.cache.misses
        t0 = time.perf_counter()
        design = self.driver.compile(self.graph, name=self.name, config=cfg)
        compile_s = time.perf_counter() - t0
        cached = self.driver.cache.misses == misses

        err = self._numeric_err(design, fmt)
        tol = self.tol_abs if fmt is None else self.tol_rel * self._ref_denom
        valid = err <= tol

        feasible, failures = True, []
        if self.budget is not None:
            from repro_torch.trigger.budget import check_design
            rep = check_design(design, self.budget)
            feasible, failures = rep.passed, rep.failures

        measured = self._measure_us(design) if self.measure else None
        self.n_evals += 1
        return Trial(
            candidate=candidate, design_hash=design.design_hash,
            latency_us=design.sample_latency_us, makespan=design.makespan,
            stage_ii=design.stage_ii, err=err, valid=valid,
            resources=design.schedule.resources(),
            wire_bits=fmt.wire_bits if fmt is not None else 32,
            est_roofline_us=roofline_estimate_us(design),
            measured_us=measured, compile_s=compile_s, cached=cached,
            feasible=feasible, budget_failures=failures)

    def compile_candidate(self, candidate: Candidate) -> CompiledDesign:
        """The design for a (stored) candidate — how serving loads a win."""
        return self.driver.compile(self.graph, name=self.name,
                                   config=self.space.to_config(candidate))
