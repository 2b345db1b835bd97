"""Behavioural verification — testbench generation (paper §3.2).

OpenHLS trades formal correctness of its rewrites for development-time
speed, and recovers confidence through *behavioural* verification: generated
testbenches drive random vectors through (a) the unoptimised DFG, (b) the
optimised/scheduled DFG, (c) the FloPoCo functional model (quantised
evaluation), (d) the emitted ``simd`` design on a torch device and (e) an
optional independent tensor-level reference, then compare.  This module is
the cocotb/iverilog analogue; its seeded feeds also serve the pass
manager's spot-verify hook and the front door's input inference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.ir import Graph
from repro_torch.core.precision import FloatFormat


def input_shapes(g: Graph) -> dict[str, tuple[int, ...]]:
    """Reconstruct memref shapes from interface tables (max index + 1)."""
    shapes = {}
    for name, table in g.inputs.items():
        rank = len(next(iter(table)))
        shapes[name] = tuple(max(i[d] for i in table) + 1 for d in range(rank))
    return shapes


def random_feeds(g: Graph, *, batch: int = 4, seed: int = 0,
                 scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    feeds = {}
    for name, shape in input_shapes(g).items():
        feeds[name] = rng.normal(0.0, scale, size=(batch,) + shape).astype(
            np.float32)
    return feeds


@dataclasses.dataclass
class TestbenchReport:
    name: str
    n_ops_raw: int
    n_ops_opt: int
    makespan: int
    max_abs_err_opt: float        # optimised DFG vs raw DFG
    max_abs_err_ref: float        # raw DFG vs tensor reference (if given)
    max_abs_err_quant: float      # quantised functional model vs raw DFG
    max_abs_err_simd: float       # emitted SIMD design vs raw DFG
    build_seconds: float
    passed: bool

    def summary(self) -> str:
        return (f"[{'PASS' if self.passed else 'FAIL'}] {self.name}: "
                f"ops {self.n_ops_raw}->{self.n_ops_opt}, "
                f"intervals={self.makespan}, "
                f"err(opt)={self.max_abs_err_opt:.2e}, "
                f"err(ref)={self.max_abs_err_ref:.2e}, "
                f"err(quant)={self.max_abs_err_quant:.2e}, "
                f"err(simd)={self.max_abs_err_simd:.2e}")


def _max_err(a: dict, b: dict) -> float:
    err = 0.0
    for k in a:
        err = max(err, float(np.max(np.abs(np.asarray(a[k])
                                           - np.asarray(b[k])))))
    return err


def run_testbench(
    name: str,
    build: Optional[Callable] = None,
    *,
    design=None,
    driver=None,
    ref_fn: Optional[Callable[[dict[str, np.ndarray]], dict]] = None,
    fmt: Optional[FloatFormat] = None,
    batch: int = 4,
    seed: int = 0,
    scale: float = 1.0,
    atol: float = 1e-3,
    ref_atol: float = 5e-2,
    check_simd: bool = True,
    tree_threshold: int = 4,
    feed_transforms: Optional[dict] = None,
    device=None,
) -> TestbenchReport:
    """Behaviourally verify one design.

    Either pass ``build`` (a ``Context -> None`` builder: the testbench
    compiles it through ``CompilerDriver``) or an already-compiled
    ``design`` (a ``CompiledDesign``) — the testbench then consumes the
    artifact directly instead of re-running the flow.

    ``feed_transforms``: per-input-name callables applied to the random
    feeds (e.g. ``abs`` for a variance input).  ``device`` is where the
    emitted ``simd`` design runs (default ``"cuda"``, which raises without
    a GPU).
    """
    from repro_torch.core import emit
    from repro_torch.core.pipeline import CompilerConfig, CompilerDriver

    report_name = name
    if design is None:
        if build is None:
            raise ValueError("run_testbench needs either build= or design=")
        drv = driver or CompilerDriver(
            CompilerConfig(tree_threshold=tree_threshold))
        design = drv.compile(build, name=name)
    g_raw, g_opt = design.graph_raw, design.graph_opt
    build_s = design.timings.get("total_s", 0.0)

    feeds = random_feeds(g_raw, batch=batch, seed=seed, scale=scale)
    for fname, fn in (feed_transforms or {}).items():
        feeds[fname] = np.asarray(fn(feeds[fname]), dtype=np.float32)
    out_raw = emit.evaluate(g_raw, feeds)
    out_opt = emit.evaluate(g_opt, feeds)
    err_opt = _max_err(out_raw, out_opt)

    err_ref = 0.0
    if ref_fn is not None:
        out_ref = ref_fn(feeds)
        err_ref = _max_err(out_raw, out_ref)

    err_quant = 0.0
    if fmt is not None:
        out_q = emit.evaluate(g_opt, feeds, fmt=fmt)
        err_quant = _max_err(out_raw, out_q)

    err_simd = 0.0
    if check_simd:
        fn = design.torch_fn(backend="simd", device=device)
        out_simd = {k: v.cpu().numpy() for k, v in fn(feeds).items()}
        err_simd = _max_err(out_raw, out_simd)

    # reassociation (reduction trees) and fmac fusion change rounding; the
    # optimised design must match within reassociation tolerance, the
    # reference within modelling tolerance (Taylor-series exp etc.).
    passed = (err_opt <= atol and err_simd <= atol
              and (ref_fn is None or err_ref <= ref_atol))
    return TestbenchReport(
        name=report_name, n_ops_raw=len(g_raw.ops), n_ops_opt=len(g_opt.ops),
        makespan=design.makespan, max_abs_err_opt=err_opt,
        max_abs_err_ref=err_ref, max_abs_err_quant=err_quant,
        max_abs_err_simd=err_simd, build_seconds=build_s, passed=passed)
