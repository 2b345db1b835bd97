"""BraggNN low-latency inference — the paper's deployment scenario (§4.2).

    python -m repro_torch.examples.braggnn_serve
    python -m repro_torch.examples.braggnn_serve --tuned
    python -m repro_torch.examples.braggnn_serve --pipeline cse,dce
    python -m repro_torch.examples.braggnn_serve --engine --save b.design
    python -m repro_torch.examples.braggnn_serve --engine --load b.design
    python -m repro_torch.examples.braggnn_serve --device cpu

Trains BraggNN briefly on synthetic Bragg peaks on the card (autograd over
the plain tensor twin, :mod:`repro_torch.optim.adamw`), binds the trained
weights into the declarative module graph (``models.braggnn.build``), and
compiles it through the public API — ``repro_torch.hls.compile``
auto-lowers the module to the paper's loop nests via the bridge.  Batched
peak-localisation requests are then served through ``Design.serve``'s
reduced-precision tensor path — (5,4) by default, or whatever format the
tuned candidate carries.

``--tuned`` loads the best known compile configuration from the persistent
``TuningDB`` via ``Design.apply_tuned`` (populate it with
``python -m repro_torch.tune --config braggnn``; a miss names the DB path it
probed); ``--pipeline`` overrides the pass pipeline by hand.  Designs are
cached under the port's versioned cache root (``cache=True``), so warm runs
serve the schedule from disk.

``--engine`` additionally fronts the design with the async adaptive-
batching engine (``Design.engine``) and prints its tail-latency summary;
``--save PATH`` persists the warm-boot artifact, ``--load PATH`` boots
from one instead of training + compiling (and is the engine's replica-
restart source).

``--trace-out PATH`` turns on :mod:`repro_torch.obs` for the whole run and
exports the compile-and-serve timeline as Chrome-trace JSON (summarise it
with ``python -m repro_torch.obs PATH``).  ``--device cpu`` runs it all on
the CPU.
"""

import argparse
import time
import torch

import repro_torch.hls as hls
from repro_torch import obs
from repro_torch.core import device as devices
from repro_torch.core.pipeline import parse_pipeline_spec
from repro_torch.models import braggnn
from repro_torch.nn.module import init_tree, map_tree
from repro_torch.optim import adamw

log = obs.get_logger(__name__)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tuned", action="store_true",
                    help="load the best compile config from the TuningDB")
    ap.add_argument("--pipeline", default=None, metavar="P1,P2,...",
                    help="override the pass pipeline (comma-separated)")
    ap.add_argument("--db", default=None,
                    help="TuningDB path (default: the port's cache root)")
    ap.add_argument("--engine", action="store_true",
                    help="also serve through the async adaptive-batching "
                         "engine and print its tail-latency summary")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="persist the warm-boot artifact (Design.save)")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="boot from a saved artifact instead of "
                         "training + compiling (hls.load)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable repro_torch.obs and export the run's "
                         "Chrome-trace JSON to PATH")
    ap.add_argument("--device", default="cuda",
                    help="where it trains and serves (default: cuda)")
    return ap.parse_args(argv)


def train(model: hls.ModuleGraph, steps: int = 150, *, device=None) -> dict:
    """Brief synthetic-peak training run on ``device`` (default: the card):
    AdamW at batch 64; returns the trained param tree there.  The init and
    the peaks come from seeded generators."""
    dev = devices.resolve(device)
    params = map_tree(lambda t: t.to(dev), init_tree(
        model.specs(), torch.Generator().manual_seed(0)))
    opt_cfg = adamw.AdamWConfig(peak_lr=2e-3, warmup_steps=10,
                                total_steps=steps, weight_decay=0.0)
    state = adamw.init_state(params)
    step = braggnn.make_step(opt_cfg, s=model.meta["s"])
    gen = torch.Generator().manual_seed(1)
    loss = torch.zeros(())
    for _ in range(steps):
        x, y = braggnn.synthetic_peaks(64, model.meta["img"], gen)
        params, state, loss = step(params, state, x.to(dev), y.to(dev))
    log.info("trained BraggNN on %s: %d steps, loss %.4f", dev, steps,
             float(loss))
    return params


def serve_engine(design, serve_fmt, save_path=None) -> None:
    """Front the design with the async engine; print the tail-latency
    summary (and where a poisoned replica would warm-boot from)."""
    x, _ = braggnn.synthetic_peaks(256, generator=torch.Generator()
                                   .manual_seed(7))
    samples = x[:, None]                          # (N, 1, img, img) memrefs
    eng = design.engine(backend="tensor", fmt=serve_fmt, max_batch=16,
                        max_delay_ms=2.0, artifact_path=save_path)
    with eng:
        reqs = [eng.submit(s) for s in samples]
        for r in reqs:
            r.wait(timeout=60)
    log.info("engine: %s", eng.report().summary())


def main(argv=None) -> None:
    args = parse_args(argv)
    obs.setup_logging()
    if args.trace_out:
        obs.enable()

    try:
        _run(args)
    finally:
        if args.trace_out:
            path = obs.export_chrome_trace(args.trace_out)
            log.info("obs: exported Chrome trace to %s "
                     "(`python -m repro_torch.obs %s`)", path, path)


def _run(args) -> None:
    peaks = torch.Generator().manual_seed(7)
    if args.load:
        # --- warm boot: one disk read, no training, no compile -------------
        t0 = time.perf_counter()
        design = hls.load(args.load, device=args.device)
        log.info("warm boot from %s: %.2fs (%s, hash %s)", args.load,
                 time.perf_counter() - t0, design.name,
                 design.design_hash[:12])
        serve_fmt = design.manifest.get("fmt")
        if args.engine:
            serve_engine(design, serve_fmt, save_path=args.load)
        else:
            x, _ = braggnn.synthetic_peaks(1024, generator=peaks)
            log.info("%s", design.serve([x] * 10, fmt=serve_fmt,
                                        backend="tensor").summary())
        return

    # --- describe once, train, bind ----------------------------------------
    model = braggnn.build(s=1)
    trained = train(model, device=args.device)
    model = model.bind(map_tree(lambda t: t.detach().cpu(), trained))

    # --- compile through the public API (shared on-disk design cache) ------
    config, serve_fmt, source = hls.CompilerConfig(n_stages=3), "5_4", \
        "default"
    if args.pipeline is not None:
        try:
            names = parse_pipeline_spec(args.pipeline)
        except ValueError as e:
            raise SystemExit(str(e))
        config = hls.CompilerConfig(pipeline=names, n_stages=3)
        source = f"--pipeline {','.join(names) or '(none)'}"

    tuned_space = db = None
    if args.tuned:
        from repro_torch.tune import TuningDB, braggnn_space
        tuned_space = braggnn_space()
        db = TuningDB(args.db) if args.db else None
    t0 = time.perf_counter()
    # the tuned config (if any) is resolved before the single compile; a
    # TuningDB miss prints which DB path was probed
    design = hls.compile(model, name="braggnn_s1", config=config,
                         cache=True, tuned=tuned_space, db=db,
                         device=args.device)
    if design.tuned_candidate is not None:
        fmt = design.tuned_candidate.get("precision", "5_4")
        serve_fmt = None if fmt == "fp32" else fmt
        source = f"tuned ({design.tuned_candidate.label()})"
    compile_s = time.perf_counter() - t0

    # report the latency of the configuration actually deployed: stage II
    # when the config pipelines, plain makespan when it does not
    stage = (f"{design.config.n_stages}-stage II={design.stage_ii}"
             if design.stage_ii is not None else "unpipelined")
    served_from = "cache" if design.session.stats()["hits"] else \
        "cold compile"
    log.info("OpenHLS schedule [%s] (%s, %.1fs): %s intervals total, "
             "%s -> %.2f us/sample "
             "(paper: 1238 total, 3-stage II=480 -> 4.8 us/sample)",
             source, served_from, compile_s, design.makespan, stage,
             design.sample_latency_us)

    # --- serve batches at the deployed precision ---------------------------
    x, y = braggnn.synthetic_peaks(1024, generator=peaks)
    report = design.serve([x] * 10, fmt=serve_fmt, backend="tensor",
                          collect=True)
    pred = report.outputs[-1].cpu()
    err_px = float(torch.mean(torch.abs(pred / 10.0 - y))) * 11
    log.info("%s; mean localisation error %.3f px", report.summary(),
             err_px)

    # --- warm-boot artifact + async engine ---------------------------------
    if args.save:
        path = design.save(args.save, backend="tensor", fmt=serve_fmt)
        log.info("saved warm-boot artifact: %s (%s bytes)", path,
                 f"{path.stat().st_size:,}")
    if args.engine:
        serve_engine(design, serve_fmt, save_path=args.save)


if __name__ == "__main__":
    main()
