"""``repro_torch.hls`` implementation: ``compile() -> Design`` and ``Session``.

The hls4ml-shaped front door (``convert(model) -> hls_model`` with
``.predict()/.build()``): one ``compile`` call accepts a ``ModuleGraph``
(auto-lowered through :mod:`repro_torch.hls.bridge`), a hand-written
loop-nest build function, or an already-traced ``Graph``, and returns a
:class:`Design` handle over the internal ``CompiledDesign`` artifact — run,
verify, tune, serve, report, all from one object.  ``repro_torch.core``
remains the internal layer underneath; nothing here re-implements the
flow.

Every session has a device, ``"cuda"`` unless the caller asks for the CPU
(``device="cpu"``); without a GPU the default raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import device as devices
from repro_torch.core.cachedir import cache_root
from repro_torch.core.interp import Context
from repro_torch.core.ir import Graph
from repro_torch.core.pipeline import (CompiledDesign, CompilerConfig,
                                       CompilerDriver, DesignCache,
                                       graph_fingerprint)
from repro_torch.hls import bridge
from repro_torch.nn.graph import ModuleGraph

log = obs.get_logger(__name__)

#: What ``compile`` accepts: a module graph, a loop-nest build callable
#: (``Context -> None``), or an already-traced DFG.
Model = Union[ModuleGraph, Callable[[Context], None], Graph]

#: serving backends: the compiled rendering on the CUDA kernels (nest or
#: DFG tier), the plain tensor twin, or the emitted SIMD design
SERVE_BACKENDS = ("cuda", "tensor", "simd")


def _as_program(model: Model):
    """-> (program for the driver, ModuleGraph or None)."""
    if isinstance(model, ModuleGraph):
        return bridge.build_fn(model), model
    if isinstance(model, Graph) or callable(model):
        return model, None
    raise TypeError(
        f"hls.compile expects a ModuleGraph, a build callable "
        f"(Context -> None) or a traced Graph, got {type(model).__name__}")


def _default_name(model: Model, module: Optional[ModuleGraph]) -> str:
    if module is not None:
        return module.name
    if isinstance(model, Graph):
        return "design"
    return getattr(model, "__name__", "design").replace("<lambda>", "design")


def _host(x) -> np.ndarray:
    """An array or tensor (any device) as an fp32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _copy_tree(tree):
    """A tensor or dict of tensors, copied (on its device)."""
    if isinstance(tree, dict):
        return {k: v.clone() for k, v in tree.items()}
    return tree.clone()


def _to_device(tree, dev: torch.device):
    """A nested dict of arrays/tensors -> fp32 tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32).to(dev)


# ---------------------------------------------------------------------------
# Serving report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeReport:
    """Throughput accounting for one :meth:`Design.serve` run.

    The percentiles are over per-batch dispatch latencies, each measured
    on the host clock around a batch that ends in a device synchronise.
    For this caller-driven loop the queue depth is always 0.
    """

    backend: str
    fmt: Optional[str]
    device: str = ""
    batches: int = 0
    samples: int = 0
    wall_s: float = 0.0
    warmup_s: float = 0.0
    #: per-batch outputs, only kept when ``collect=True``
    outputs: Optional[list] = None
    #: what actually served — the lowering plan's summary (tier, kernels,
    #: fallback count); equals ``backend`` otherwise
    served: Optional[str] = None
    #: per-node plain-PyTorch fallbacks the lowering took
    fallbacks: list = dataclasses.field(default_factory=list)
    #: per-batch dispatch-latency percentiles (milliseconds)
    p50_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    max_queue_depth: int = 0
    mean_queue_depth: float = 0.0

    @property
    def us_per_sample(self) -> float:
        return self.wall_s / self.samples * 1e6 if self.samples else 0.0

    def summary(self) -> str:
        fmt = "fp32" if self.fmt in (None, "fp32") else \
            f"({self.fmt.replace('_', ',')})"
        served = self.served or self.backend
        return (f"served {self.samples} samples in {self.batches} batches: "
                f"{self.us_per_sample:.2f} us/sample, batch p50 "
                f"{self.p50_ms:.2f} / p95 {self.p95_ms:.2f} / p99 "
                f"{self.p99_ms:.2f} ms [{served} backend on {self.device}, "
                f"{fmt}; warm-up {self.warmup_s:.2f}s]")


# ---------------------------------------------------------------------------
# The Design handle
# ---------------------------------------------------------------------------


class Design:
    """A compiled design plus everything you do with one.

    Wraps the internal ``CompiledDesign`` artifact (available as
    ``.compiled``; its fields — ``graph_raw``, ``graph_opt``,
    ``schedule``, ``timings``, ``pass_reports``, ``design_hash``, ... —
    are delegated, so ``design.makespan`` etc. work directly) and keeps
    the session, source program and module-graph context needed for the
    verbs: :meth:`run`, :meth:`torch_fn`, :meth:`verify`, :meth:`tune`,
    :meth:`apply_tuned`, :meth:`with_config`, :meth:`serve`,
    :meth:`report`.
    """

    def __init__(self, compiled: CompiledDesign, session: "Session", *,
                 program=None, module: Optional[ModuleGraph] = None,
                 example_inputs=None, tuned_candidate=None):
        self._compiled = compiled
        self._session = session
        self._program = program
        self._module = module
        self._tuned_candidate = tuned_candidate
        #: warmed-bucket manifest when this design came from ``hls.load``
        self.manifest: Optional[dict] = None
        self.example_inputs = example_inputs
        if example_inputs is not None:           # early shape validation
            if isinstance(example_inputs, dict):
                unknown = set(example_inputs) - set(compiled.graph_raw.inputs)
                if unknown:
                    raise ValueError(
                        f"example_inputs name unknown memrefs {sorted(unknown)}; "
                        f"graph inputs: {sorted(compiled.graph_raw.inputs)}")
            else:
                self._coerce_input(example_inputs)

    # -- delegation ---------------------------------------------------------

    @property
    def compiled(self) -> CompiledDesign:
        """The underlying ``CompiledDesign`` (stable internal artifact)."""
        return self._compiled

    @property
    def session(self) -> "Session":
        return self._session

    @property
    def module(self) -> Optional[ModuleGraph]:
        return self._module

    @property
    def tuned_candidate(self):
        """The ``Candidate`` this design was tuned to, if any."""
        return self._tuned_candidate

    @property
    def precision(self) -> Optional[str]:
        """FloPoCo format key carried by the tuned candidate (None=fp32)."""
        if self._tuned_candidate is None:
            return None
        fmt = self._tuned_candidate.get("precision")
        return None if fmt in (None, "fp32") else fmt

    @property
    def device(self) -> torch.device:
        """Where :meth:`serve` and :meth:`torch_fn` run by default."""
        return self._session.device

    @property
    def fingerprint(self) -> str:
        """Content hash of the traced DFG (the cache identity)."""
        return graph_fingerprint(self._compiled.graph_raw)

    def __getattr__(self, name: str):
        # everything else (makespan, schedule, timings, ...) is the
        # artifact's business — delegate rather than mirror
        try:
            compiled = self.__dict__["_compiled"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(compiled, name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Design({self._compiled.summary()})"

    # -- feeds --------------------------------------------------------------

    def _input_memref(self) -> tuple[str, tuple[int, ...]]:
        if self._module is not None:
            return self._module.input_name, self._module.input_shape
        g = self._compiled.graph_raw
        data = [n for n in g.inputs if n not in g.weight_names]
        if len(data) != 1:
            raise ValueError(
                f"cannot infer the input memref (non-weight inputs: {data}) "
                f"— pass a feed dict instead of a bare array")
        from repro_torch.core.verify import input_shapes
        return data[0], input_shapes(g)[data[0]]

    def _coerce_input(self, x) -> dict:
        """A bare input (numpy or tensor) -> ``{memref: (B,) + shape or
        shape}``; tensors stay on their device."""
        name, shape = self._input_memref()
        arr = x if isinstance(x, torch.Tensor) \
            else np.asarray(x, dtype=np.float32)
        got = tuple(arr.shape)
        if got == tuple(shape) or got[1:] == tuple(shape):
            return {name: arr}
        if shape[0] == 1 and got[1:] == tuple(shape)[1:]:
            # natural batch (B, *shape[1:]) -> (B,) + shape
            return {name: arr[:, None]}
        raise ValueError(
            f"input shape {got} does not match memref {name!r} "
            f"shape {tuple(shape)} (optionally with a leading batch axis)")

    def _input_of(self, x) -> dict:
        """One batch (bare input or feed dict) -> ``{input memref: x}``."""
        if isinstance(x, dict):
            name, _ = self._input_memref()
            return {name: x[name]}
        return self._coerce_input(x)

    def _feed_dict(self, x) -> dict:
        """One batch as a feed dict: a dict as given, a bare input
        coerced; tensors stay on their device."""
        return dict(x) if isinstance(x, dict) else self._coerce_input(x)

    def _batch_size(self, x) -> int:
        """Samples in one batch (a bare input or a feed dict)."""
        name, shape = self._input_memref()
        if isinstance(x, dict):
            if name not in x:
                return 1
            x = x[name]
            dims = tuple(np.shape(x)) if not isinstance(x, torch.Tensor) \
                else tuple(x.shape)
            return int(dims[0]) if len(dims) == len(shape) + 1 else 1
        dims = tuple(x.shape) if isinstance(x, torch.Tensor) \
            else tuple(np.shape(x))
        if dims == tuple(shape):
            return 1
        return int(dims[0])

    def feeds(self, inputs=None) -> dict[str, np.ndarray]:
        """A full numpy feed dict: ``inputs`` (array, tensor or partial
        dict, or the ``example_inputs`` given at compile time) merged with
        the bound module weights."""
        if inputs is None:
            inputs = self.example_inputs
        if inputs is None:
            raise ValueError("no inputs given and no example_inputs bound")
        feeds = dict(inputs) if isinstance(inputs, dict) \
            else self._coerce_input(inputs)
        feeds = {k: _host(v) for k, v in feeds.items()}
        if self._module is not None:
            for k, v in self._module.weight_feeds().items():
                feeds.setdefault(k, v)
        return feeds

    # -- execution ----------------------------------------------------------

    def run(self, inputs=None, *, fmt=None, raw: bool = False
            ) -> dict[str, np.ndarray]:
        """Vectorised functional simulation of the design (numpy).

        ``inputs``: a feed dict, a bare (optionally batched) input array,
        or None to use ``example_inputs``.  Module weights bound at build
        time are fed automatically.  ``fmt`` quantises through the FloPoCo
        functional model; ``raw=True`` evaluates the unoptimised DFG.
        """
        return self._compiled.evaluate(self.feeds(inputs), fmt=fmt, raw=raw)

    def torch_fn(self, *, backend: str = "cuda", device=None,
                 **cuda_kw) -> Callable:
        """The emitted design as a torch callable.

        ``backend='cuda'``: the compiled rendering on the hand-written
        kernels — the nest tier, or the generic DFG tier with
        ``mode='dfg'`` (the source ``ModuleGraph`` and its bound weights
        are passed automatically when the design was compiled from one);
        extra keywords (``fmt=``, ``weights=``, ``mode=``, ``nlb_flash=``,
        ...) forward to :func:`repro_torch.core.emit_cuda.to_cuda_fn`, and
        the result carries its lowering ``.plan``.  ``backend='simd'``:
        the cached gather/compute/scatter interpretation, fed a full feed
        dict.  ``device`` defaults to the session's.
        """
        from repro_torch.core.emit import EMIT_BACKENDS
        if backend not in EMIT_BACKENDS:
            raise ValueError(f"unknown emission backend {backend!r} "
                             f"(valid: {', '.join(EMIT_BACKENDS)})")
        if backend == "cuda":
            cuda_kw.setdefault("module", self._module)
        cuda_kw["device"] = self.device if device is None else device
        return self._compiled.torch_fn(backend=backend, **cuda_kw)

    # -- verification -------------------------------------------------------

    def verify(self, *, ref_fn=None, batch: int = 4, seed: int = 0,
               scale: float = 1.0, fmt=None, atol: float = 1e-3,
               ref_atol: float = 5e-2, device=None, **kw):
        """Behavioural testbench vs the interpreter reference (paper §3.2).

        Random vectors through the raw DFG, the optimised DFG, the
        emitted SIMD design on ``device`` (default: the session's), and
        (with ``fmt``) the FloPoCo functional model; returns a
        ``TestbenchReport`` whose ``passed`` folds the tolerances.
        ``ref_fn`` optionally adds an independent tensor-level reference.
        """
        from repro_torch.core.verify import run_testbench
        return run_testbench(self.name, design=self._compiled, ref_fn=ref_fn,
                             batch=batch, seed=seed, scale=scale, fmt=fmt,
                             atol=atol, ref_atol=ref_atol,
                             device=self.device if device is None
                             else device, **kw)

    # -- reconfiguration ----------------------------------------------------

    def with_config(self, config: CompilerConfig, *,
                    name: Optional[str] = None) -> "Design":
        """Recompile under a different config, sharing the traced graph
        (and the session's pass-stage memo) whenever the trace mode
        (``config.forward``) allows it."""
        if config.forward != self._compiled.config.forward:
            if self._program is None or isinstance(self._program, Graph):
                raise ValueError(
                    "config.forward differs from this design's trace mode "
                    "and no build program is available to re-trace")
            program = self._program          # re-trace in the other mode
        else:
            program = self._compiled.graph_raw
        compiled = self._session.driver.compile(
            program, name=name or self.name, config=config)
        return Design(compiled, self._session, program=self._program,
                      module=self._module,
                      example_inputs=self.example_inputs)

    # -- tuning -------------------------------------------------------------

    def tune(self, space, *, strategy: str = "hillclimb", budget=8,
             db=None, dry: bool = True, force: bool = False,
             target_us: Optional[float] = None, on_trial=None,
             batch: int = 2, seed: int = 0, scale: float = 0.4,
             tol_abs: float = 1e-3, tol_rel: float = 5e-2,
             measure_reps: int = 5, trigger_budget=None, part=None,
             trials: Optional[int] = None):
        """Search ``space`` over this design (delegates to
        ``repro_torch.tune``).

        Results auto-persist to the ``TuningDB`` (the port's versioned
        cache root unless ``db`` overrides) keyed by this design's
        fingerprint; a covered rerun is served from the DB without
        searching.  Candidates compile through this design's session, so
        they share the trace, the design cache and the pass-stage memo.
        With ``dry=False`` each candidate's DFG tier is also timed on the
        session's device (``Trial.measured_us``).  Returns a
        ``TuneResult``; apply the win with :meth:`apply_tuned`.

        ``budget`` is the trial count (int) — but a
        :class:`repro_torch.trigger.TriggerBudget` passed here (or via the
        explicit ``trigger_budget=`` / ``part=`` keywords) becomes a hard
        feasibility gate instead: a candidate whose compiled schedule
        blows the latency/II/resource envelope scores ``None`` and can
        never win, mirroring the numerics gate.  When ``budget`` carries
        the envelope, the trial count comes from ``trials`` (default 8).
        """
        from repro_torch.trigger import TriggerBudget
        from repro_torch.tune import Evaluator, Tuner, TuningDB
        from repro_torch.tune.strategies import Bisection, make_strategy
        if isinstance(budget, TriggerBudget):
            if trigger_budget is not None:
                raise ValueError("pass the TriggerBudget either as budget= "
                                 "or trigger_budget=, not both")
            trigger_budget, budget = budget, (trials or 8)
        elif trials is not None:
            budget = trials
        if part is not None:
            trigger_budget = (TriggerBudget(part=part)
                              if trigger_budget is None
                              else dataclasses.replace(trigger_budget,
                                                       part=part))
        db = db if db is not None else TuningDB()
        if space.base.forward == self._compiled.config.forward:
            program = self._compiled.graph_raw
        elif self._program is not None and not isinstance(self._program,
                                                          Graph):
            program = self._program
        else:
            raise ValueError(
                "space.base.forward differs from this design's trace mode "
                "and no build program is available to re-trace")
        evaluator = Evaluator(program, space, driver=self._session.driver,
                              name=self.name, batch=batch, seed=seed,
                              scale=scale, tol_abs=tol_abs, tol_rel=tol_rel,
                              measure=not dry, measure_reps=measure_reps,
                              budget=trigger_budget, device=self.device)
        strat = (Bisection(target_us=target_us) if strategy == "bisect"
                 else make_strategy(strategy)) if isinstance(strategy, str) \
            else strategy
        tuner = Tuner(evaluator, strat, db=db, budget=budget,
                      on_trial=on_trial)
        return tuner.run(force=force)

    def apply_tuned(self, space, *, db=None, verbose: bool = True
                    ) -> tuple["Design", Optional[Any]]:
        """Auto-load the best tuned config for this design from the DB.

        Returns ``(tuned design, candidate)`` on a hit; on a miss returns
        ``(self, None)`` and — no silent fallback — says exactly which DB
        path was probed and how to populate it.  Serve the tuned design at
        its format with ``serve(fmt=design.precision)``.
        """
        from repro_torch.tune import TuningDB, best_config_for
        db = db if db is not None else TuningDB()
        hit = best_config_for(self._compiled.graph_raw, space, db=db)
        if hit is None:
            if verbose:
                log.warning(
                    "no tuned config for design %s / space %r: probed "
                    "TuningDB %s (cache root %s) — run "
                    "`python -m repro_torch.tune` or design.tune(space) "
                    "first; keeping the current config",
                    self.fingerprint[:12], space.name, db.path,
                    db.path.parent)
            return self, None
        config, candidate = hit
        design = self.with_config(config)
        design._tuned_candidate = candidate
        return design, candidate

    # -- serving ------------------------------------------------------------

    def serve(self, batch_iter: Iterable, *, fmt: Optional[str] = None,
              backend: Optional[str] = None, device=None,
              collect: bool = False, on_batch=None,
              cuda_kw: Optional[dict] = None) -> ServeReport:
        """The warmed batched serving loop.

        ``backend='cuda'`` runs the compiled rendering on the hand-written
        kernels — the nest tier, or with ``cuda_kw={"mode": "dfg"}`` the
        generic DFG tier (other lowering keywords, e.g. ``nlb_flash``, via
        ``cuda_kw`` too) — recording the plan and any fallbacks in the
        report; ``backend='tensor'`` runs the module's plain tensor twin
        (requires a bound ``ModuleGraph`` with a ``forward_fn``) at
        FloPoCo format key ``fmt``; ``backend='simd'`` runs the emitted
        SIMD design (fp32 only).  Default: tensor when available, else
        cuda.  Weights move to ``device`` (default:
        the session's) once, before the first batch.  The first batch is
        also run once untimed as the warm-up; on the card that run captures
        its shape as a CUDA graph, as the first batch of any other shape
        does, and every later batch of the shape replays it.  Every batch is
        synchronised individually, server-style.  ``on_batch(i, out)`` is
        called per batch; ``collect=True`` additionally keeps outputs; both
        get copies, which later batches do not overwrite.
        """
        if backend is None:
            backend = ("tensor" if self._module is not None
                       and self._module.forward_fn is not None
                       and self._module.params is not None else "cuda")
        dev = self.device if device is None else devices.resolve(device)
        run_one, served, fallbacks = self._runner(backend, fmt, dev, cuda_kw)

        report = ServeReport(backend=backend, fmt=fmt, device=str(dev),
                             outputs=[] if collect else None,
                             served=served, fallbacks=fallbacks)
        it = iter(batch_iter)
        try:
            first = next(it)
        except StopIteration:
            return report
        t0 = time.perf_counter()
        with obs.span("serve.warmup", cat="serve", backend=backend,
                      design=self.name):
            run_one(first)
            devices.synchronize(dev)
        report.warmup_s = time.perf_counter() - t0

        batch_s: list[float] = []
        for i, x in enumerate(itertools.chain((first,), it)):
            t0 = time.perf_counter()
            with obs.span("serve.batch", cat="serve", backend=backend,
                          batch=i):
                out = run_one(x)
                devices.synchronize(dev)
            batch_s.append(time.perf_counter() - t0)
            report.wall_s += batch_s[-1]
            report.batches += 1
            report.samples += self._batch_size(x)
            if on_batch is not None or collect:
                # a replayed graph's outputs are overwritten by the next
                # batch: hand out copies
                out = _copy_tree(out) if dev.type == "cuda" else out
            if on_batch is not None:
                on_batch(i, out)
            if collect:
                report.outputs.append(out)
        from repro_torch.serving.common import percentiles
        pct = percentiles(batch_s)
        report.p50_ms = pct["p50"] * 1e3
        report.p95_ms = pct["p95"] * 1e3
        report.p99_ms = pct["p99"] * 1e3
        if report.samples:
            obs.gauge(f"serve.us_per_sample.{backend}",
                      report.us_per_sample)
        return report

    def _runner(self, backend: str, fmt: Optional[str], dev: torch.device,
                cuda_kw: Optional[dict]):
        """``(run_one, served, fallbacks)`` for one serving backend.

        ``run_one`` takes one batch — a bare input array/tensor or a feed
        dict holding the input memref (for the DFG tier and ``simd``, a
        feed dict may carry weight feeds too, which then take precedence)
        — and returns the outputs on ``dev``.  Weights are uploaded here,
        once.  Shared by :meth:`serve`, the async
        :class:`~repro_torch.serving.design_engine.DesignEngine` and the
        trigger, so all three serve through the same programs.

        On a CUDA device ``run_one`` is a
        :class:`~repro_torch.core.graphs.GraphRunner`: each batch shape's
        first call runs eagerly and captures a CUDA graph, and every later
        call copies the batch into the graph's static inputs and replays
        it, returning outputs that the next replay overwrites.
        ``run_one.release()`` frees the graphs; ``run_one.eager`` runs a
        batch with no graph.
        """
        from repro_torch.core.graphs import GraphRunner
        served = None
        fallbacks: list = []
        feeds_of = self._feed_dict
        if backend == "tensor":
            if (self._module is None or self._module.forward_fn is None
                    or self._module.params is None):
                raise ValueError("tensor backend needs a ModuleGraph with "
                                 "bound params and a forward_fn")
            params = _to_device(self._module.params, dev)
            fwd = self._module.forward_fn
            name, shape = self._input_memref()
            natural = tuple(shape[1:]) if shape[0] == 1 else tuple(shape)
            feeds_of = self._input_of

            def call(feeds):
                x = torch.as_tensor(feeds[name], dtype=torch.float32,
                                    device=dev)
                with torch.inference_mode():
                    return fwd(params, x.reshape((-1,) + natural), fmt=fmt)
        elif backend == "cuda":
            call = self.torch_fn(backend="cuda", fmt=fmt, device=dev,
                                 **(cuda_kw or {}))
            served = call.plan.summary()
            fallbacks = list(call.plan.fallbacks)
            if call.plan.mode != "dfg":
                # weights are bound (on the device) when the fn is built;
                # the nest tier reads only the input memref
                feeds_of = self._input_of
        elif backend == "simd":
            if fmt not in (None, "fp32"):
                raise ValueError("the emitted SIMD design runs fp32; use "
                                 "backend='tensor' or backend='cuda' with "
                                 "cuda_kw={'mode': 'dfg'} for quantised "
                                 "serving")
            fn = self.torch_fn(backend="simd", device=dev)
            wdev = {} if self._module is None else _to_device(
                self._module.weight_feeds(), dev)

            def call(feeds):
                return fn({**wdev, **feeds})
        else:
            raise ValueError(f"unknown backend {backend!r} "
                             f"(expected one of {SERVE_BACKENDS})")
        graphed = GraphRunner(call, dev)

        def run_one(x):
            return graphed(feeds_of(x))

        run_one.release = graphed.release
        run_one.graphs = graphed
        # the same call with no graph, for checks that hold a replay to it
        run_one.eager = lambda x: call(feeds_of(x))
        return run_one, served, fallbacks

    def engine(self, **kw):
        """An async adaptive-batching engine over this design.

        Returns a :class:`repro_torch.serving.design_engine.DesignEngine`:
        requests queue and dispatch in bucket-snapped batches (size or
        deadline trigger), each bucket a captured CUDA graph on the card,
        with fault-tolerant replica restart.  ``backend``/``fmt``/
        ``buckets`` default from the saved artifact's manifest when this
        design came from :func:`load`; pass ``artifact_path=`` so replica
        restarts warm-boot from disk.  All :class:`DesignEngine` keywords
        forward.
        """
        from repro_torch.serving.design_engine import DesignEngine
        manifest = self.manifest or {}
        for key in ("backend", "fmt"):
            if kw.get(key) is None and manifest.get(key) is not None:
                kw[key] = manifest[key]
        # the saved warmed-bucket set only defaults when the caller pinned
        # neither buckets nor max_batch — an explicit max_batch must win
        # (the engine derives its buckets from it)
        if kw.get("buckets") is None and "max_batch" not in kw \
                and manifest.get("buckets"):
            kw["buckets"] = manifest["buckets"]
        if kw.get("artifact_path") is None and manifest.get("path"):
            kw["artifact_path"] = manifest["path"]
        return DesignEngine(self, **kw)

    # -- hard-real-time trigger ----------------------------------------------

    def check_budget(self, budget=None, *, part=None):
        """Check this design against a trigger envelope.

        ``budget`` is a :class:`repro_torch.trigger.TriggerBudget`;
        ``part`` is a named/synthetic :class:`repro_torch.trigger.Part`
        (shorthand for a resource-caps-only budget, and an override of the
        budget's own part when both are given).  Returns the structured
        :class:`repro_torch.trigger.BudgetReport` — ``.passed``,
        ``.failures`` (named offending constraints), ``.summary()``,
        ``.raise_if_failed()``::

            design.check_budget(part="alveo_u280").raise_if_failed()
        """
        from repro_torch.trigger import check_design
        return check_design(self, budget, part=part)

    def trigger(self, **kw):
        """A streaming trigger loop over this design.

        Returns a :class:`repro_torch.trigger.TriggerLoop` (warmed on
        construction: its one window shape captured as a CUDA graph on the
        card): feed it a :class:`repro_torch.trigger.DetectorFeed` via
        ``loop.run(feed, n_frames, realtime=...)`` for accept/reject
        decisions with per-window deadline accounting.  All
        ``TriggerLoop`` keywords forward (``backend``, ``device``,
        ``budget``, ``threshold``, ``window``, ``capacity``...).
        """
        from repro_torch.trigger import TriggerLoop
        return TriggerLoop(self, **kw)

    # -- persistence (warm-boot artifacts) -----------------------------------

    def save(self, path: Union[str, Path], *,
             buckets: Optional[Sequence[int]] = None,
             backend: Optional[str] = None,
             fmt: Optional[str] = None) -> Path:
        """Persist a warm-boot artifact: design + weights + bucket manifest.

        The artifact bundles the full ``CompiledDesign`` (graphs, schedule,
        pass reports), the bound module with its params as numpy arrays
        (so an artifact saved on the card loads on the CPU and the other
        way round; an unpicklable ``forward_fn`` is dropped, disabling only
        the tensor backend), the example inputs, and a serving manifest
        (``buckets``/``backend``/``fmt`` defaults for :meth:`engine`).
        :func:`load` boots a replica from it without re-tracing or
        re-running passes — and the engine's restart path re-loads it when
        a replica is poisoned.  Written through
        :func:`repro_torch.core.pipeline.save_artifact`, whose header a
        load checks before it unpickles anything.
        """
        from repro_torch.core.pipeline import save_artifact
        module = self._module
        module_payload = None
        if module is not None:
            params = devices.to_host(module.params) \
                if module.params is not None else None
            fwd = module.forward_fn
            if fwd is not None:
                import pickle
                try:
                    pickle.dumps(fwd)
                except Exception:
                    fwd = None      # lambda forward: artifact serves via
                    #                 simd/cuda only
            module_payload = ModuleGraph(
                module.name, module.input_shape, module.nodes,
                input_name=module.input_name, params=params,
                forward_fn=fwd, meta=module.meta)
        if buckets is None:
            from repro_torch.serving.design_engine import default_buckets
            buckets = default_buckets(32)
        manifest = {"buckets": list(buckets), "backend": backend,
                    "fmt": fmt, "name": self.name,
                    "design_hash": self.design_hash,
                    "fingerprint": self.fingerprint}
        example = self.example_inputs
        if example is not None:
            example = devices.to_host(example)
        return save_artifact(path, {
            "design": self._compiled, "module": module_payload,
            "example_inputs": example, "manifest": manifest})

    # -- reporting ----------------------------------------------------------

    def report(self, *, budget=None, part=None) -> str:
        """Pass / schedule / latency summary of the whole artifact.

        With ``budget=`` (a :class:`repro_torch.trigger.TriggerBudget`)
        and/or ``part=`` a budget-check section is appended — the same
        structured verdict :meth:`check_budget` returns, rendered one
        constraint per line.

        For the live span/metric view of a compile-and-serve run, enable
        :mod:`repro_torch.obs` (``obs.enable()`` or ``REPRO_OBS=1``): an
        extra ``obs`` line then summarises the recorded spans and cache
        counters.
        """
        d = self._compiled
        res = d.schedule.resources()
        lines = [d.summary()]
        lines.append(
            f"  pipeline : {', '.join(d.config.pipeline) or '(none)'}")
        for rep in d.pass_reports:
            if rep.ops_delta:
                lines.append(f"    {rep.summary()}")
        skipped = sum(1 for r in d.pass_reports if r.skipped)
        if skipped:
            lines.append(f"    ({skipped} pass applications skipped by the "
                         f"incremental fixpoint)")
        stage = (f"{d.config.n_stages}-stage pipeline, II={d.stage_ii}"
                 if d.stage_ii is not None else "unpipelined")
        lines.append(f"  schedule : {d.makespan} intervals "
                     f"({d.latency_us:.2f} us end-to-end), {stage} -> "
                     f"{d.sample_latency_us:.2f} us/sample")
        lines.append(f"  resources: {res}")
        t = d.timings
        lines.append(f"  compile  : {t.get('total_s', 0.0):.2f}s "
                     f"(trace {t.get('trace_s', 0.0):.2f} / passes "
                     f"{t.get('passes_s', 0.0):.2f} / schedule "
                     f"{t.get('schedule_s', 0.0):.2f})")
        lines.append(f"  device   : {self.device}")
        if self._tuned_candidate is not None:
            lines.append(f"  tuned    : {self._tuned_candidate.label()}")
        if budget is not None or part is not None:
            rep = self.check_budget(budget, part=part)
            lines += ["  " + ln for ln in rep.summary().splitlines()]
        if obs.enabled():
            counters = obs.snapshot()["counters"]
            lines.append(
                f"  obs      : {len(obs.tracer.spans())} spans recorded, "
                f"cache {counters.get('design_cache.hits', 0):.0f} hits / "
                f"{counters.get('design_cache.misses', 0):.0f} misses — "
                f"obs.export_chrome_trace(path), then "
                f"`python -m repro_torch.obs <trace.json>`")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Sessions + the module-level front door
# ---------------------------------------------------------------------------


class Session:
    """One compiler instance: config + design cache + pass-stage memo, and
    the device its designs run on.

    Every ``Design`` remembers its session, so recompiles
    (:meth:`Design.with_config`) share the trace and the caches.  The
    module-level :func:`compile` uses a process default per (cache,
    device); make your own for isolation (``max_memory_entries``) or a
    private on-disk cache (``cache_dir``).  ``device`` defaults to
    ``"cuda"`` and raises without a GPU.
    """

    def __init__(self, *, config: Optional[CompilerConfig] = None,
                 cache_dir: Optional[Union[str, Path]] = None,
                 max_memory_entries: Optional[int] = None, device=None):
        self.device = devices.resolve(device)
        self.driver = CompilerDriver(
            config, cache=DesignCache(cache_dir,
                                      max_memory_entries=max_memory_entries))

    def compile(self, model: Model, *, name: Optional[str] = None,
                config: Optional[CompilerConfig] = None,
                example_inputs=None, tuned=None, db=None) -> Design:
        program, module = _as_program(model)
        to_compile: Union[Graph, Callable] = program
        candidate = None
        if tuned is not None:
            # resolve the tuned config BEFORE the (only) compile: trace,
            # probe the TuningDB by fingerprint, then lower once.  ``tuned``
            # is a SearchSpace; a miss keeps ``config`` and says which DB
            # path was probed (never a silent fallback).
            from repro_torch.tune import TuningDB, best_config_for
            db = db if db is not None else TuningDB()
            cfg_fwd = (config or self.driver.config).forward
            if not isinstance(to_compile, Graph):
                to_compile = self.driver.trace(program, forward=cfg_fwd)
            hit = best_config_for(to_compile, tuned, db=db)
            if hit is not None:
                config, candidate = hit
                if config.forward != cfg_fwd:
                    if isinstance(program, Graph):
                        raise ValueError(
                            "tuned config.forward differs from the given "
                            "graph's trace mode; pass a build callable")
                    to_compile = self.driver.trace(program,
                                                   forward=config.forward)
            else:
                log.warning(
                    "no tuned config for design %s / space %r: probed "
                    "TuningDB %s — run `python -m repro_torch.tune` or "
                    "design.tune(space) first; compiling the given config",
                    graph_fingerprint(to_compile)[:12], tuned.name, db.path)
        compiled = self.driver.compile(
            to_compile, name=name or _default_name(model, module),
            config=config)
        return Design(compiled, self, program=program, module=module,
                      example_inputs=example_inputs,
                      tuned_candidate=candidate)

    def stats(self) -> dict[str, int]:
        """Compile-side telemetry of the session: design-cache hits and
        misses, full builds, and the sizes of the in-memory design cache
        and the pass-stage memo."""
        return {"hits": self.driver.cache.hits,
                "misses": self.driver.cache.misses,
                "recompiles": self.driver.recompiles,
                "memory_entries": len(self.driver.cache.memory),
                "pass_memo_entries": len(self.driver._opt_memo),
                "pass_memo_hits": self.driver.pass_memo_hits}


#: process-default sessions, one per (cache location, device)
_sessions: dict[tuple[str, str], Session] = {}


def _default_session(cache: Union[bool, str, Path, None] = False,
                     device=None) -> Session:
    if cache is True:
        cache_dir: Optional[Path] = cache_root("designs")
    elif cache:
        cache_dir = Path(cache)
    else:
        cache_dir = None
    key = (str(cache_dir or ""), str(devices.resolve(device)))
    if key not in _sessions:
        _sessions[key] = Session(cache_dir=cache_dir, device=device)
    return _sessions[key]


def compile(model: Model, *, name: Optional[str] = None,
            config: Optional[CompilerConfig] = None, example_inputs=None,
            cache: Union[bool, str, Path, None] = False,
            session: Optional[Session] = None, device=None, tuned=None,
            db=None) -> Design:
    """Compile a model to a deployable :class:`Design` (the front door).

    ``model`` is a :class:`~repro_torch.nn.graph.ModuleGraph` (auto-lowered
    to loop nests through the bridge), a hand-written build callable
    (``Context -> None``) or an already-traced ``Graph``.
    ``example_inputs`` optionally binds (and shape-checks) a default input
    batch for :meth:`Design.run`.  ``cache=True`` persists designs under
    the port's versioned cache root (``cache=<path>`` under a private
    one).  ``device`` (default ``"cuda"``, which raises without a GPU) is
    where the design serves; a given ``session`` brings its own.
    ``tuned`` (a ``SearchSpace``) resolves the best known config from the
    ``TuningDB`` (``db`` overrides the port's own) before the single
    compile — a miss logs the probed DB path and keeps ``config``.
    """
    s = session if session is not None else _default_session(cache, device)
    return s.compile(model, name=name, config=config,
                     example_inputs=example_inputs, tuned=tuned, db=db)


def load(path: Union[str, Path], *, session: Optional[Session] = None,
         device=None) -> Design:
    """Warm-boot a :class:`Design` from a ``Design.save`` artifact.

    No re-trace, no passes, no scheduling: the pickled ``CompiledDesign``
    (plus the bound module weights and example inputs) is rehydrated as-is,
    so a replica serves its first request after one disk read.  The params
    are bound as tensors on the session's device: ``device`` (default
    ``"cuda"``, which raises without a GPU; ``"cpu"`` when asked for), or a
    given ``session``'s own.  The artifact's warmed-bucket manifest rides
    along on ``design.manifest`` and defaults :meth:`Design.engine`'s
    backend/fmt/buckets; the manifest also remembers this path, so engine
    replica restarts re-load from it automatically.  A file that is not
    this package's artifact — the reference package's included — raises
    ``ValueError`` before anything is unpickled.
    """
    from repro_torch.core.pipeline import load_artifact
    record = load_artifact(path)
    s = session if session is not None else _default_session(device=device)
    compiled = record["design"]
    module = record.get("module")
    if module is not None and module.params is not None:
        module = module.bind(_to_device(module.params, s.device))
    design = Design(compiled, s, module=module,
                    example_inputs=record.get("example_inputs"))
    design.manifest = dict(record.get("manifest") or {})
    design.manifest["path"] = str(path)
    # seed the session's design cache: a warm boot also warms recompiles
    s.driver.cache.memory.setdefault(compiled.design_hash, compiled)
    return design


def trace(model: Model, *, forward: bool = True) -> Graph:
    """Just the trace: symbolically interpret ``model`` into its DFG.

    The cheap way to a ``graph_fingerprint`` (design identity for cache
    probes) without running passes or the scheduler.
    """
    program, _ = _as_program(model)
    if isinstance(program, Graph):
        return program
    ctx = Context(forward=forward)
    program(ctx)
    return ctx.finalize()
