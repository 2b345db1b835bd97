"""Flow orchestration: PassManager + CompilerDriver (paper Fig. 1).

The paper's pipeline — trace (symbolic interpretation) -> DFG ->
transformations -> scheduling -> emission -> behavioural verification —
lives here as a single orchestrated flow instead of being re-stitched by
every consumer:

  * ``register_pass``   — decorator-based pass registry.  A pass is any
                          ``Graph -> Graph`` rewrite; options are keyword
                          arguments (e.g. ``reduction_tree``'s threshold).
  * ``PassManager``     — runs a named pipeline to a fixpoint with per-pass
                          instrumentation: op-histogram deltas, wall time,
                          and optional ``topo_check`` / behavioural
                          spot-verify hooks.  Produces one ``PassReport``
                          per pass application.
  * ``CompilerDriver``  — ``compile()`` runs trace -> optimize -> schedule
                          (emission is lazy) and returns a
                          ``CompiledDesign`` bundling every artifact plus a
                          content hash.  Designs are cached in memory and
                          optionally on disk keyed by that hash, so repeated
                          compiles (serving warm-up, benchmark sweeps) are
                          free.

``passes.optimize`` remains as a thin compatibility wrapper over
``PassManager`` — the two produce bit-identical graphs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch import obs
from repro_torch.core import emit, passes
from repro_torch.core.cachedir import CACHE_FORMAT_VERSION
from repro_torch.core.interp import Context
from repro_torch.core.ir import Graph
from repro_torch.core.precision import FloatFormat
from repro_torch.core.schedule import (Schedule, ScheduleParams, list_schedule,
                                 partition_stages)

# ---------------------------------------------------------------------------
# Pass registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PassInfo:
    """A registered pass plus the metadata the incremental fixpoint uses.

    matches:
        the opcodes whose presence/shape this pass's pattern depends on, or
        ``None`` for "anything" (liveness/use-count driven passes).  A pass
        is skipped in a fixpoint round when no opcode it matches was touched
        since its own last application — it provably has nothing new to see.
    self_clean:
        True when the pass is a fixpoint of itself (running it twice in a
        row never changes the second output).  Non-self-clean passes (e.g.
        ``reduction_tree``, which re-rebalances the leftmost spine of its
        own trees) stay dirty after any application that changed the graph.
    """

    fn: Callable[..., Graph]
    matches: Optional[frozenset] = None
    self_clean: bool = False


#: name -> PassInfo.  Populated by ``register_pass``.
PASS_REGISTRY: dict[str, PassInfo] = {}


def register_pass(name: str, *, matches: Optional[frozenset] = None,
                  self_clean: bool = False
                  ) -> Callable[[Callable[..., Graph]], Callable[..., Graph]]:
    """Register ``fn`` as a named pass usable in any pipeline.

    ``fn(g, **options) -> Graph`` must return a rewritten graph whose
    program order is a valid topological order (the built-in passes check
    it with ``Graph.topo_check``).  A pass that has nothing to
    rewrite should return its input graph *object* unchanged — that is the
    signal the incremental fixpoint uses to mark it clean; passes that
    rewrite may annotate the result with ``_touched`` (a frozenset of
    opcode names) so downstream passes with disjoint ``matches`` can be
    skipped.  Conservative defaults (``matches=None``, ``self_clean=False``)
    make an unannotated external pass always re-run while anything changes.
    """
    def deco(fn: Callable[..., Graph]) -> Callable[..., Graph]:
        if name in PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        PASS_REGISTRY[name] = PassInfo(
            fn, frozenset(matches) if matches is not None else None,
            self_clean)
        return fn
    return deco


# The paper's §3.2 inventory, registered under the names the string pipeline
# always used so existing ``pipeline=(...)`` arguments keep working.
# ``matches`` is the dependence footprint of each pattern:
#   * cse keys on every arith row (a touched arith op can create a dup);
#   * relu_recompose only reads cmpugt/select rows (and consts, which never
#     change after tracing);
#   * reduction_tree and fmac_coalesce gate on use counts, which any op
#     change can shift — they match everything;
#   * dce is liveness-driven — any change can strand a value.
register_pass("cse", matches=passes.ARITH_OPS, self_clean=True)(passes.cse)
register_pass("relu_recompose", matches=frozenset({"cmpugt", "select"}),
              self_clean=True)(passes.relu_recompose)
register_pass("reduction_tree")(passes.reduction_tree)
register_pass("fmac_coalesce", self_clean=True)(passes.fmac_coalesce)
register_pass("dce", self_clean=True)(passes.dce)

DEFAULT_PIPELINE: tuple[str, ...] = tuple(passes.DEFAULT_PIPELINE)


def parse_pipeline_spec(spec: str) -> tuple[str, ...]:
    """Parse a ``"cse,dce"``-style CLI pipeline spec against the registry.

    Raises ``ValueError`` naming the first unknown pass; empty segments are
    dropped, so ``""`` is the empty pipeline.
    """
    names = tuple(p for p in (s.strip() for s in spec.split(",")) if p)
    unknown = [p for p in names if p not in PASS_REGISTRY]
    if unknown:
        raise ValueError(f"unknown pass {unknown[0]!r}; registered: "
                         f"{sorted(PASS_REGISTRY)}")
    return names


# ---------------------------------------------------------------------------
# Per-pass instrumentation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PassReport:
    """Instrumentation for one application of one pass."""

    name: str
    round: int
    ops_before: int
    ops_after: int
    hist_before: dict[str, int]
    hist_after: dict[str, int]
    wall_s: float
    topo_ok: Optional[bool] = None       # None = check not requested
    spot_err: Optional[float] = None     # None = spot-verify not requested
    #: True when the incremental fixpoint proved this application a no-op
    #: (none of the pass's matched opcodes were touched since its last run)
    #: and skipped it.  Skipped reports carry zero wall time and identical
    #: before/after histograms.
    skipped: bool = False

    @property
    def ops_delta(self) -> int:
        return self.ops_after - self.ops_before

    def hist_delta(self) -> dict[str, int]:
        """Per-opcode op-count change (only non-zero entries)."""
        keys = set(self.hist_before) | set(self.hist_after)
        delta = {k: self.hist_after.get(k, 0) - self.hist_before.get(k, 0)
                 for k in sorted(keys)}
        return {k: v for k, v in delta.items() if v}

    def summary(self) -> str:
        if self.skipped:
            return (f"[round {self.round}] {self.name}: skipped "
                    f"(matched opcodes untouched)")
        d = self.hist_delta()
        extra = f" {d}" if d else ""
        return (f"[round {self.round}] {self.name}: "
                f"{self.ops_before} -> {self.ops_after} ops "
                f"({self.wall_s * 1e3:.1f} ms){extra}")


def behavioural_spot_check(*, batch: int = 2, seed: int = 0,
                           scale: float = 0.5) -> Callable[[Graph, Graph, str], float]:
    """Build a spot-verify hook: evaluate both graphs on tiny random feeds.

    Returns max-abs deviation of the rewritten graph vs its input graph —
    the per-pass miniature of the paper's behavioural testbenches.  Imported
    lazily by ``PassManager`` when ``spot_verify=True``.
    """
    def check(g_before: Graph, g_after: Graph, name: str) -> float:
        from repro_torch.core import verify
        feeds = verify.random_feeds(g_before, batch=batch, seed=seed,
                                    scale=scale)
        out_a = emit.evaluate(g_before, feeds)
        out_b = emit.evaluate(g_after, feeds)
        err = 0.0
        for k in out_a:
            err = max(err, float(np.max(np.abs(out_a[k] - out_b[k]))))
        return err
    return check


class PassManager:
    """Drives a named pass pipeline to a fixpoint with instrumentation.

    Fixpoint criterion matches the historical ``passes.optimize``: rounds
    repeat (up to ``max_rounds``) until a full round leaves the op count
    unchanged — passes expose each other's opportunities (e.g. DCE drops a
    second use of a mul, enabling FMAC coalescing next round).
    """

    def __init__(
        self,
        pipeline: Sequence[str] = DEFAULT_PIPELINE,
        *,
        max_rounds: int = 4,
        pass_options: Optional[dict[str, dict]] = None,
        topo_check: bool = False,
        spot_verify: Union[bool, Callable[[Graph, Graph, str], float]] = False,
    ):
        unknown = [n for n in pipeline if n not in PASS_REGISTRY]
        if unknown:
            raise ValueError(
                f"unknown pass {unknown[0]!r}; registered: "
                f"{sorted(PASS_REGISTRY)}")
        self.pipeline = tuple(pipeline)
        self.max_rounds = max_rounds
        self.pass_options = dict(pass_options or {})
        self.topo_check = topo_check
        if spot_verify is True:
            spot_verify = behavioural_spot_check()
        self.spot_verify = spot_verify or None

    def run(self, g: Graph) -> tuple[Graph, list[PassReport]]:
        passes.hoist_globals_check(g)
        reports: list[PassReport] = []
        ALL = None   # dirty sentinel: everything touched
        # dirty[p]: opcodes touched since p's last application (ALL before
        # its first).  A round skips p when its matched opcodes are all
        # untouched — p would provably find nothing new.  The fixpoint
        # criterion itself is unchanged (a full round with a stable op
        # count terminates), so skipping never alters the final graph.
        dirty: dict[str, Optional[set]] = {n: ALL for n in self.pipeline}
        changed_last: dict[str, bool] = {}
        infos = {n: PASS_REGISTRY[n] for n in self.pipeline}
        for rnd in range(self.max_rounds):
            before = len(g.ops)
            with obs.span(f"passes.round{rnd}", cat="compile",
                          round=rnd) as round_sp:
                for name in self.pipeline:
                    info = infos[name]
                    d = dirty[name]
                    must_run = (d is ALL
                                or (not info.self_clean
                                    and changed_last.get(name, False)))
                    if not must_run and d:
                        must_run = (info.matches is None
                                    or bool(info.matches & d))
                    if not must_run:
                        hist = g.op_histogram()
                        reports.append(PassReport(
                            name=name, round=rnd, ops_before=len(g.ops),
                            ops_after=len(g.ops), hist_before=hist,
                            hist_after=hist, wall_s=0.0, skipped=True))
                        obs.inc("compile.passes_skipped")
                        continue
                    opts = self.pass_options.get(name, {})
                    hist_before = g.op_histogram()
                    n_before = len(g.ops)
                    t0 = time.perf_counter()
                    with obs.span(f"passes.{name}", cat="compile",
                                  round=rnd) as pass_sp:
                        g_new = info.fn(g, **opts)
                        pass_sp.set(ops_before=n_before,
                                    ops_after=len(g_new.ops),
                                    delta=len(g_new.ops) - n_before)
                    wall = time.perf_counter() - t0
                    rep = PassReport(
                        name=name, round=rnd, ops_before=n_before,
                        ops_after=len(g_new.ops), hist_before=hist_before,
                        hist_after=g_new.op_histogram(), wall_s=wall)
                    if self.topo_check:
                        try:
                            g_new.topo_check()
                            rep.topo_ok = True
                        except ValueError:
                            rep.topo_ok = False
                            reports.append(rep)
                            raise
                    if self.spot_verify is not None:
                        rep.spot_err = self.spot_verify(g, g_new, name)
                    reports.append(rep)
                    obs.inc("compile.passes_run")
                    changed = g_new is not g
                    changed_last[name] = changed
                    dirty[name] = set()
                    if changed:
                        touched = getattr(g_new, "_touched", None)
                        for other in self.pipeline:
                            if other == name:
                                continue
                            if touched is None or dirty[other] is ALL:
                                dirty[other] = ALL
                            else:
                                dirty[other] = dirty[other] | touched
                    g = g_new
                round_sp.set(ops_before=before, ops_after=len(g.ops))
            if len(g.ops) == before:
                break
        return g, reports


# ---------------------------------------------------------------------------
# Compile configuration + artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompilerConfig:
    """Everything that determines the compiled design besides the program.

    Hashable and canonically serialisable — it is folded into the design
    hash, so changing any field is a cache miss.
    """

    pipeline: tuple[str, ...] = DEFAULT_PIPELINE
    tree_threshold: int = 4
    max_rounds: int = 4
    forward: bool = True                 # store-load forwarding in the trace
    binding: str = "pool"
    unroll_factor: Optional[int] = None
    ports_per_array: int = 2
    pipelined_units: bool = False
    alap_compact: bool = True
    n_stages: int = 1                    # pipeline-partition factor (§4.2)
    topo_check: bool = False
    spot_verify: bool = False

    def pass_manager(self) -> PassManager:
        return PassManager(
            self.pipeline, max_rounds=self.max_rounds,
            pass_options={"reduction_tree": {"threshold": self.tree_threshold}},
            topo_check=self.topo_check, spot_verify=self.spot_verify)

    def schedule_params(self) -> ScheduleParams:
        """The schedule-stage slice of the config, as a first-class bundle."""
        return ScheduleParams(
            binding=self.binding, unroll_factor=self.unroll_factor,
            ports_per_array=self.ports_per_array,
            pipelined_units=self.pipelined_units,
            alap_compact=self.alap_compact, n_stages=self.n_stages)

    def pass_key(self) -> str:
        """Canonical string over the fields that determine the *optimised
        graph* (not the schedule).  Two configs sharing a pass key can share
        one pass-stage run — the lever design-space search leans on: mutating
        a schedule knob re-schedules in ~0.1x the cost of re-optimising.
        """
        return repr((self.pipeline, self.tree_threshold, self.max_rounds,
                     self.forward, self.topo_check, self.spot_verify))

    def key(self) -> str:
        """Canonical string folded into the design hash."""
        return repr(tuple(sorted(dataclasses.asdict(self).items())))


def graph_fingerprint(g: Graph) -> str:
    """Content hash of a DFG: ops, constants and interface tables.

    Two structurally identical graphs (same program traced twice) produce
    the same fingerprint — value ids are deterministic under tracing.
    Memoised on the graph object: graphs are frozen after ``finalize`` or a
    pass's rewrite, and benchmark sweeps hash the same traced graph
    once per config.
    """
    cached = getattr(g, "_fingerprint", None)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    # hash the raw column bytes — same information as the historical per-op
    # string rendering at a fraction of the cost (17 MB/s of ops -> one
    # memcpy-speed digest); array names are hashed alongside so interned
    # array ids keep their meaning
    c = g.cols()
    h.update(f"soa:{c.n}:{g.n_values}".encode())
    for arr in (c.opcode, c.args, c.result, c.nest, c.rank, c.array_id):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr(g.array_names).encode())
    h.update(repr(sorted(g.consts.items())).encode())
    for label, tables in (("in", g.inputs), ("out", g.outputs)):
        for name in sorted(tables):
            h.update(f"{label}:{name}:{sorted(tables[name].items())}".encode())
    h.update(repr(sorted(g.weight_names)).encode())
    h.update(repr(sorted(g.nest_parallel_space.items())).encode())
    digest = h.hexdigest()
    g._fingerprint = digest
    return digest


@dataclasses.dataclass
class CompiledDesign:
    """The full artifact of one ``CompilerDriver.compile`` run.

    Bundles the raw (traced) graph, the optimised graph, the resource-
    constrained ``Schedule``, per-pass ``PassReport``s, stage timings, and
    the content hash that keys the design cache.  Emitted callables are
    built on demand by :meth:`torch_fn` and never pickled.

    ``timings`` always describe the compile that *built* the artifact; a
    cache-served design keeps its original build cost.
    """

    name: str
    config: CompilerConfig
    graph_raw: Graph
    graph_opt: Graph
    schedule: Schedule
    pass_reports: list[PassReport]
    design_hash: str
    timings: dict[str, float]
    #: Stage partition, materialised at compile time when
    #: ``config.n_stages > 1`` (paper §4.2's pipelined deployment); both
    #: stay ``None`` for unpipelined designs.
    stages: Optional[list[list[int]]] = None
    stage_ii: Optional[int] = None

    # -- derived metrics ----------------------------------------------------

    @property
    def makespan(self) -> int:
        return self.schedule.makespan

    @property
    def latency_us(self) -> float:
        return self.schedule.latency_us

    @property
    def sample_latency_us(self) -> float:
        """Per-sample latency of the deployed design: the initiation
        interval when the design is stage-pipelined, else the makespan."""
        intervals = self.stage_ii if self.stage_ii is not None \
            else self.schedule.makespan
        from repro_torch.core.schedule import CLOCK_NS
        return intervals * CLOCK_NS * 1e-3

    def pass_time_by_name(self) -> dict[str, float]:
        """Total wall time per pass name across all fixpoint rounds."""
        out: dict[str, float] = {}
        for rep in self.pass_reports:
            out[rep.name] = out.get(rep.name, 0.0) + rep.wall_s
        return out

    def pass_throughput_ops_s(self) -> float:
        """Ops/second through the pass pipeline (executed applications only).

        The compiler-throughput figure benchmarks track across PRs: total
        ops entering each executed pass application divided by total pass
        wall time.  0.0 when nothing was timed (e.g. a cache-served design
        compiled before this field existed).
        """
        wall = sum(r.wall_s for r in self.pass_reports if not r.skipped)
        ops = sum(r.ops_before for r in self.pass_reports if not r.skipped)
        return ops / wall if wall > 0 else 0.0

    # -- execution backends -------------------------------------------------

    def torch_fn(self, *, backend: str = "cuda", **cuda_kw) -> Callable:
        """The emitted design as a torch callable, rebuilt per call since
        its lowering depends on the extra keywords (``module=``, ``fmt=``,
        ``device=``, ...) — see :func:`repro_torch.core.emit.to_torch_fn`.
        """
        return emit.to_torch_fn(self.graph_opt, backend=backend, **cuda_kw)

    def evaluate(self, feeds: dict, *, fmt: Optional[FloatFormat] = None,
                 raw: bool = False) -> dict:
        """Functional simulation (optionally quantised / on the raw graph)."""
        g = self.graph_raw if raw else self.graph_opt
        return emit.evaluate(g, feeds, fmt=fmt)

    def partition(self, n_stages: int) -> tuple[list[list[int]], int]:
        """Pipeline the design: (stages as nest-id lists, initiation interval)."""
        return partition_stages(self.graph_opt, self.schedule, n_stages)

    def summary(self) -> str:
        res = self.schedule.resources()
        return (f"{self.name}: ops {len(self.graph_raw.ops)} -> "
                f"{len(self.graph_opt.ops)}, intervals={self.makespan} "
                f"({self.latency_us:.2f} us, "
                f"{self.sample_latency_us:.2f} us/sample), "
                f"resources={res}, hash={self.design_hash[:12]}")


# ---------------------------------------------------------------------------
# Warm-boot design artifacts
# ---------------------------------------------------------------------------

#: First bytes-level sanity mark of a ``Design.save`` artifact file.
ARTIFACT_MAGIC = "repro-design-artifact"


def save_artifact(path: Union[str, Path], payload: dict) -> Path:
    """Persist a warm-boot design artifact (versioned pickle, atomic write).

    ``payload`` is the ``Design.save`` bundle: the ``CompiledDesign``, the
    (numpy-ified) bound module, example inputs and the warmed-bucket
    manifest.  The pickle shares the design cache's format version, so a
    layout change invalidates saved artifacts the same way it invalidates
    cached designs — :func:`load_artifact` rejects stale files loudly
    instead of unpickling into incompatible objects.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = {"magic": ARTIFACT_MAGIC, "version": CACHE_FORMAT_VERSION,
              **payload}
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(record, f)
    tmp.replace(path)
    return path


def load_artifact(path: Union[str, Path]) -> dict:
    """Load and validate a ``save_artifact`` file.

    Raises ``FileNotFoundError`` / ``ValueError`` with the exact reason
    (missing, not an artifact, or saved under a different
    ``CACHE_FORMAT_VERSION`` — re-save from a fresh compile).
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no design artifact at {path}")
    with open(path, "rb") as f:
        record = pickle.load(f)
    if not isinstance(record, dict) or record.get("magic") != ARTIFACT_MAGIC:
        raise ValueError(f"{path} is not a repro design artifact")
    version = record.get("version")
    if version != CACHE_FORMAT_VERSION:
        raise ValueError(
            f"design artifact {path} was saved with format version "
            f"{version}, this build expects {CACHE_FORMAT_VERSION} — "
            f"recompile and Design.save again")
    return record


# ---------------------------------------------------------------------------
# Design cache
# ---------------------------------------------------------------------------


class DesignCache:
    """In-memory + optional on-disk cache of ``CompiledDesign`` artifacts.

    Keyed by the design hash (graph fingerprint + config key).  The disk
    layer stores one pickle per design under ``cache_dir``.
    """

    def __init__(self, cache_dir: Optional[Union[str, Path]] = None, *,
                 max_memory_entries: Optional[int] = None):
        self.memory: dict[str, CompiledDesign] = {}
        self.max_memory_entries = max_memory_entries
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            # entries are pickles: refuse a directory another user controls
            self.cache_dir.mkdir(parents=True, exist_ok=True, mode=0o700)
            if hasattr(os, "getuid"):
                st = self.cache_dir.stat()
                if st.st_uid != os.getuid():
                    raise RuntimeError(
                        f"design cache dir {self.cache_dir} is owned by "
                        f"uid {st.st_uid}, not the current user — refusing "
                        f"to load pickles from it")
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> Optional[Path]:
        return self.cache_dir / f"{key}.pkl" if self.cache_dir else None

    def get(self, key: str) -> Optional[CompiledDesign]:
        design = self.memory.get(key)
        if design is not None:
            self.hits += 1
            obs.inc("design_cache.hits")
            return design
        path = self._path(key)
        if path is not None and path.exists():
            try:
                with open(path, "rb") as f:
                    design = pickle.load(f)
            except Exception:
                design = None       # corrupt entry: treat as miss
            if design is not None:
                self.memory[key] = design
                self.hits += 1
                obs.inc("design_cache.hits")
                return design
        self.misses += 1
        obs.inc("design_cache.misses")
        return None

    def put(self, key: str, design: CompiledDesign) -> None:
        self.memory[key] = design
        if self.max_memory_entries is not None:
            while len(self.memory) > self.max_memory_entries:
                self.memory.pop(next(iter(self.memory)))  # evict oldest
        path = self._path(key)
        if path is not None:
            tmp = path.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(design, f)
            tmp.replace(path)

    def clear(self) -> None:
        self.memory.clear()
        if self.cache_dir:
            for p in self.cache_dir.glob("*.pkl"):
                p.unlink()


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

BuildFn = Callable[[Context], None]


class CompilerDriver:
    """Single entrypoint for the full lowering flow (paper Fig. 1).

    ``compile`` accepts either a build callable (``Context -> None``, the
    trace step runs here) or an already-traced ``Graph``, and returns a
    ``CompiledDesign``.  Repeated compiles of the same program + config are
    served from the cache (tracing still runs for build callables — the
    graph fingerprint requires the traced DFG — but passes, scheduling and
    emission are skipped).
    """

    def __init__(self, config: Optional[CompilerConfig] = None, *,
                 cache: Optional[DesignCache] = None,
                 cache_dir: Optional[Union[str, Path]] = None):
        self.config = config or CompilerConfig()
        self.cache = cache or DesignCache(cache_dir)
        #: full (non-cache-served) builds this driver has performed
        self.recompiles = 0
        #: pass-stage memo hits (builds that skipped the pass pipeline)
        self.pass_memo_hits = 0
        # pass-stage memo: (graph fingerprint, cfg.pass_key()) -> optimised
        # graph + reports.  Configs differing only in schedule knobs reuse
        # the (expensive) pass stage — the design-space explorer's hot path.
        # Precision-only tune candidates go one better: ``precision`` is not
        # a ``CompilerConfig`` field at all (``SearchSpace.to_config`` drops
        # it), so a precision step re-uses the *whole* cached design, not
        # just the pass stage (asserted by ``tests/test_tune.py``).
        self._opt_memo: dict[tuple[str, str],
                             tuple[Graph, list[PassReport]]] = {}

    # -- stages -------------------------------------------------------------

    def trace(self, build: BuildFn, *,
              forward: Optional[bool] = None) -> Graph:
        """Symbolic interpretation: run the loop nests, recover the DFG."""
        ctx = Context(forward=self.config.forward if forward is None
                      else forward)
        build(ctx)
        return ctx.finalize()

    def compile(self, program: Union[BuildFn, Graph], *,
                name: str = "design",
                config: Optional[CompilerConfig] = None) -> CompiledDesign:
        cfg = config or self.config
        timings: dict[str, float] = {}

        with obs.span("compile", cat="compile", design=name) as compile_sp:
            t0 = time.perf_counter()
            with obs.span("compile.trace", cat="compile", design=name) as sp:
                if isinstance(program, Graph):
                    g_raw = program
                else:
                    g_raw = self.trace(program, forward=cfg.forward)
                sp.set(ops=len(g_raw.ops))
            timings["trace_s"] = time.perf_counter() - t0

            key = hashlib.sha256(
                (f"v{CACHE_FORMAT_VERSION}|" + graph_fingerprint(g_raw) + "|"
                 + cfg.key()).encode()).hexdigest()
            cached = self.cache.get(key)
            if cached is not None:
                compile_sp.set(cached=True, design_hash=key[:12])
                if cached.name != name:
                    # relabel for this caller; graphs/schedule/fn stay shared
                    return dataclasses.replace(cached, name=name)
                return cached
            self.recompiles += 1
            obs.inc("compile.recompiles")

            t0 = time.perf_counter()
            memo_key = (graph_fingerprint(g_raw), cfg.pass_key())
            memoised = self._opt_memo.get(memo_key)
            with obs.span("compile.passes", cat="compile", design=name,
                          memo=memoised is not None) as sp:
                if memoised is not None:
                    g_opt, reports = memoised
                    self.pass_memo_hits += 1
                    obs.inc("compile.pass_memo_hits")
                else:
                    g_opt, reports = cfg.pass_manager().run(g_raw)
                    self._opt_memo[memo_key] = (g_opt, reports)
                sp.set(ops_before=len(g_raw.ops), ops_after=len(g_opt.ops),
                       applications=sum(1 for r in reports if not r.skipped))
            timings["passes_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            with obs.span("compile.schedule", cat="compile",
                          design=name) as sp:
                sched = list_schedule(g_opt, params=cfg.schedule_params())
                stages = stage_ii = None
                timings["partition_s"] = 0.0
                if cfg.n_stages > 1:
                    tp = time.perf_counter()
                    with obs.span("compile.partition", cat="compile",
                                  design=name, n_stages=cfg.n_stages) as psp:
                        stages, stage_ii = partition_stages(g_opt, sched,
                                                            cfg.n_stages)
                        psp.set(stage_ii=stage_ii)
                    timings["partition_s"] = time.perf_counter() - tp
                sp.set(makespan=sched.makespan, stage_ii=stage_ii)
            timings["schedule_s"] = time.perf_counter() - t0
            # partition_s is a sub-timing of schedule_s, not an extra stage
            timings["total_s"] = (timings["trace_s"] + timings["passes_s"]
                                  + timings["schedule_s"])
            if timings["total_s"] > 0:
                obs.gauge("compiler.ops_per_s",
                          len(g_raw.ops) / timings["total_s"])
            compile_sp.set(cached=False, design_hash=key[:12],
                           ops_raw=len(g_raw.ops), ops_opt=len(g_opt.ops),
                           makespan=sched.makespan,
                           **{f"{k[:-2]}_ms": round(v * 1e3, 3)
                              for k, v in timings.items()})

        design = CompiledDesign(
            name=name, config=cfg, graph_raw=g_raw, graph_opt=g_opt,
            schedule=sched, pass_reports=list(reports), design_hash=key,
            timings=timings, stages=stages, stage_ii=stage_ii)
        self.cache.put(key, design)
        return design

