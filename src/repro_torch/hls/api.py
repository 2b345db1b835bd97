"""``repro_torch.hls`` implementation: ``compile() -> Design`` and ``Session``.

The hls4ml-shaped front door (``convert(model) -> hls_model`` with
``.predict()/.build()``): one ``compile`` call accepts a ``ModuleGraph``
(auto-lowered through :mod:`repro_torch.hls.bridge`), a hand-written
loop-nest build function, or an already-traced ``Graph``, and returns a
:class:`Design` handle over the internal ``CompiledDesign`` artifact — run,
serve, report, all from one object.  ``repro_torch.core`` remains the
internal layer underneath; nothing here re-implements the flow.

Every session has a device, ``"cuda"`` unless the caller asks for the CPU
(``device="cpu"``); without a GPU the default raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import Callable, Iterable, Optional, Union

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

#: serving backends: the nest tier on the CUDA kernels, or the plain
#: tensor twin
SERVE_BACKENDS = ("cuda", "tensor")


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
    verbs: :meth:`run`, :meth:`torch_fn`, :meth:`with_config`,
    :meth:`serve`, :meth:`report`.
    """

    def __init__(self, compiled: CompiledDesign, session: "Session", *,
                 program=None, module: Optional[ModuleGraph] = None,
                 example_inputs=None):
        self._compiled = compiled
        self._session = session
        self._program = program
        self._module = module
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

        ``backend='cuda'``: the nest tier on the hand-written kernels (the
        source ``ModuleGraph`` and its bound weights are passed
        automatically when the design was compiled from one); extra
        keywords (``fmt=``, ``weights=``, ...) forward to
        :func:`repro_torch.core.emit_cuda.to_cuda_fn`, and the result
        carries its lowering ``.plan``.  ``device`` defaults to the
        session's.
        """
        from repro_torch.core.emit import EMIT_BACKENDS
        if backend not in EMIT_BACKENDS:
            raise ValueError(f"unknown emission backend {backend!r} "
                             f"(valid: {', '.join(EMIT_BACKENDS)})")
        if backend == "cuda":
            cuda_kw.setdefault("module", self._module)
            cuda_kw["device"] = self.device if device is None else device
        return self._compiled.torch_fn(backend=backend, **cuda_kw)

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

    # -- serving ------------------------------------------------------------

    def serve(self, batch_iter: Iterable, *, fmt: Optional[str] = None,
              backend: Optional[str] = None, device=None,
              collect: bool = False, on_batch=None,
              cuda_kw: Optional[dict] = None) -> ServeReport:
        """The warmed batched serving loop.

        ``backend='cuda'`` runs the nest tier on the hand-written kernels
        (extra lowering keywords via ``cuda_kw``), recording the plan and
        any per-node fallbacks in the report; ``backend='tensor'`` runs the
        module's plain tensor twin (requires a bound ``ModuleGraph`` with a
        ``forward_fn``) at FloPoCo format key ``fmt``.  Default: tensor
        when available, else cuda.  Weights move to ``device`` (default:
        the session's) once, before the first batch.  The first batch is
        also run once untimed as the warm-up; every batch is then
        synchronised individually, server-style.  ``on_batch(i, out)`` is
        called per batch; ``collect=True`` additionally keeps outputs.
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
        dict holding the input memref — and returns the outputs on
        ``dev``.  Weights are uploaded here, once.
        """
        served = None
        fallbacks: list = []
        if backend == "tensor":
            if (self._module is None or self._module.forward_fn is None
                    or self._module.params is None):
                raise ValueError("tensor backend needs a ModuleGraph with "
                                 "bound params and a forward_fn")
            params = _to_device(self._module.params, dev)
            fwd = self._module.forward_fn
            name, shape = self._input_memref()
            natural = tuple(shape[1:]) if shape[0] == 1 else tuple(shape)

            def run_one(x):
                x = torch.as_tensor(self._input_of(x)[name],
                                    dtype=torch.float32, device=dev)
                with torch.inference_mode():
                    return fwd(params, x.reshape((-1,) + natural), fmt=fmt)
        elif backend == "cuda":
            fn = self.torch_fn(backend="cuda", fmt=fmt, device=dev,
                               **(cuda_kw or {}))
            served = fn.plan.summary()
            fallbacks = list(fn.plan.fallbacks)

            def run_one(x):
                return fn(self._input_of(x))
        else:
            raise ValueError(f"unknown backend {backend!r} "
                             f"(expected one of {SERVE_BACKENDS})")
        return run_one, served, fallbacks

    # -- reporting ----------------------------------------------------------

    def report(self) -> str:
        """Pass / schedule / latency summary of the whole artifact.

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
                example_inputs=None) -> Design:
        program, module = _as_program(model)
        compiled = self.driver.compile(
            program, name=name or _default_name(model, module),
            config=config)
        return Design(compiled, self, program=program, module=module,
                      example_inputs=example_inputs)

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
            session: Optional[Session] = None, device=None) -> Design:
    """Compile a model to a deployable :class:`Design` (the front door).

    ``model`` is a :class:`~repro_torch.nn.graph.ModuleGraph` (auto-lowered
    to loop nests through the bridge), a hand-written build callable
    (``Context -> None``) or an already-traced ``Graph``.
    ``example_inputs`` optionally binds (and shape-checks) a default input
    batch for :meth:`Design.run`.  ``cache=True`` persists designs under
    the port's versioned cache root (``cache=<path>`` under a private
    one).  ``device`` (default ``"cuda"``, which raises without a GPU) is
    where the design serves; a given ``session`` brings its own.
    """
    s = session if session is not None else _default_session(cache, device)
    return s.compile(model, name=name, config=config,
                     example_inputs=example_inputs)


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
