"""``python -m repro_torch.tune`` — design-space exploration from the shell.

    PYTHONPATH=src python -m repro_torch.tune --config braggnn --budget 8
    PYTHONPATH=src python -m repro_torch.tune --config braggnn --dry --budget 3
    PYTHONPATH=src python -m repro_torch.tune --config braggnn --show

Without ``--dry`` each candidate's DFG tier (one DFG-segment kernel launch
per batch) is also timed on the card (``--device``, default ``cuda``;
``cpu`` times the kernels' plain versions).  ``--dry`` times nothing and
relies on the scheduled-latency objective plus the H100 roofline estimate;
it runs no kernel.  Results persist to the ``TuningDB`` (``--db``
overrides the port's versioned cache root); a rerun whose budget is
already covered is served from the DB without searching (``--force``
re-searches).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

from repro_torch.tune.db import TuningDB
from repro_torch.tune.space import SearchSpace, braggnn_space, conv2d_space
from repro_torch.tune.strategies import STRATEGIES
from repro_torch.tune.tuner import TuneResult


def _braggnn_build(s: int, img: int) -> Callable:
    from repro_torch.core import frontend
    return lambda ctx: frontend.braggnn(ctx, s=s, img=img)


def _conv2d_build() -> Callable:
    from repro_torch.core import frontend

    def build(ctx):
        x = ctx.memref("input", (1, 3, 8, 8), "input")
        w = ctx.memref("weight", (4, 3, 3, 3), "weight")
        b = ctx.memref("bias", (4,), "weight")
        out = ctx.memref("out", (1, 4, 6, 6), "output")
        frontend.conv2d(ctx, x, w, b, out)
    return build


def _configs() -> dict[str, tuple[Callable, SearchSpace, dict]]:
    """name -> (build fn, search space, evaluator defaults).

    BraggNN verifies at feed scale 0.2: the paper's trained weights are
    small, and at 0.4 the softmax's Taylor exp is chaotic enough that even
    (5,11) quantisation diverges from fp32 — every candidate would fail
    the numerics gate for a reason that is the test vectors' fault, not
    the design's.
    """
    from repro_torch.configs import braggnn as bragg_cfg
    full, tiny = bragg_cfg.CONFIG, bragg_cfg.tiny()
    return {
        "braggnn": (_braggnn_build(full.scale, full.img), braggnn_space(),
                    {"scale": 0.2}),
        "braggnn-tiny": (_braggnn_build(tiny.scale, tiny.img),
                         braggnn_space(), {"scale": 0.2}),
        "conv2d": (_conv2d_build(), conv2d_space(), {}),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="OpenHLS design-space exploration")
    ap.add_argument("--config", default="braggnn",
                    choices=["braggnn", "braggnn-tiny", "conv2d"],
                    help="which design to tune")
    ap.add_argument("--strategy", default="hillclimb",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--budget", type=int, default=8,
                    help="max candidates to evaluate (incl. the baseline)")
    ap.add_argument("--dry", action="store_true",
                    help="skip timing the emitted design on the device; "
                         "use the schedule latency + roofline cost model")
    ap.add_argument("--device", default="cuda",
                    help="where designs run and measure mode times them "
                         "(cuda, the default, raises without a card; cpu)")
    ap.add_argument("--target-us", type=float, default=None,
                    help="latency target for --strategy bisect "
                         "(default: the baseline's own latency)")
    ap.add_argument("--db", default=None,
                    help="TuningDB path (default: shared versioned "
                         "cache root)")
    ap.add_argument("--force", action="store_true",
                    help="re-search even when the DB already covers "
                         "this budget")
    ap.add_argument("--show", action="store_true",
                    help="print the stored result for this design/space "
                         "and exit (no search)")
    ap.add_argument("--batch", type=int, default=2,
                    help="verification batch for the numerics gate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol-rel", type=float, default=5e-2,
                    help="relative tolerance for quantised candidates")
    return ap


def main(argv: Optional[list[str]] = None) -> TuneResult:
    args = build_parser().parse_args(argv)
    build, space, eval_defaults = _configs()[args.config]
    db = TuningDB(args.db)

    if args.show:
        # inspect-only: a bare trace yields the fingerprint — skip the
        # evaluator's reference evaluation entirely
        import repro_torch.hls as hls
        from repro_torch.core.pipeline import graph_fingerprint
        from repro_torch.tune.db import best_entry
        fp = graph_fingerprint(hls.trace(build, forward=space.base.forward))
        all_entries = db.entries_for(fp, space.space_hash())
        for ctx_hash, entry in sorted(all_entries.items()):
            c = entry.get("context", {})
            print(f"  [{ctx_hash}] strategy={c.get('strategy', '?')} "
                  f"mode={(c.get('eval') or {}).get('mode', '?')} "
                  f"budget={entry.get('budget')} "
                  f"best={(entry.get('best') or {}).get('latency_us')}us "
                  f"valid={(entry.get('best') or {}).get('valid')}")
        winner = best_entry(db, fp, space.space_hash())
        if winner is None:
            print(f"no servable tuning entry in {db.path}")
            sys.exit(1)
        result = TuneResult.from_entry(winner, design_fingerprint=fp,
                                       space_hash=space.space_hash())
        print(result.summary())
        return result

    print(f"tuning {args.config!r} with strategy={args.strategy} "
          f"budget={args.budget} mode={'dry' if args.dry else 'measure'}")
    print(space.describe())

    # trace + baseline compile through the public API; the tuner's own
    # baseline trial is then a design-cache hit inside the same session
    import repro_torch.hls as hls
    print("tracing + compiling the baseline design ...", flush=True)
    design = hls.compile(build, name=args.config, config=space.base,
                         device=args.device)

    n = [0]

    def on_trial(trial):
        n[0] += 1
        print(f"  trial {n[0]:3d}  {trial.summary()}", flush=True)

    result = design.tune(space, strategy=args.strategy, budget=args.budget,
                         db=db, dry=args.dry, force=args.force,
                         target_us=args.target_us, on_trial=on_trial,
                         batch=args.batch, seed=args.seed,
                         tol_rel=args.tol_rel, **eval_defaults)

    if result.from_db:
        print(f"served from tuning DB ({db.path}) — no search run; "
              f"use --force to re-search")
    print(result.summary())
    best = result.best
    if best.measured_us is not None:
        print(f"measured DFG-tier latency on {args.device}: "
              f"{best.measured_us:.3f} us/sample "
              f"(baseline {result.baseline.measured_us:.3f})")
    else:
        print(f"roofline estimate (H100): "
              f"{best.est_roofline_us:.3f} us/sample (dry mode)")
    print(f"tuning DB: {db.path}")
    return result
