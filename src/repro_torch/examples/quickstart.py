"""Quickstart: the OpenHLS pipeline end to end on one convolution.

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.quickstart --pipeline cse,dce
    python -m repro_torch.examples.quickstart --device cpu

One ``repro_torch.hls.compile()`` call runs the whole Fig. 1 flow: the
conv2d loop nest is symbolically interpreted into an SSA DFG (store-load
forwarding included), optimised, scheduled, and returned as a ``Design``
handle.  We then behaviourally verify it, quantise to FloPoCo (5,4), and
run the design through the CUDA kernels (the generic DFG tier) on the card,
or through their plain versions with ``--device cpu``.  ``--pipeline``
selects which registered passes run (comma-separated, in order) instead of
the default §3.2 pipeline.
"""

import argparse

import numpy as np

import repro_torch.hls as hls
from repro_torch import obs
from repro_torch.core import frontend, verify
from repro_torch.core.pipeline import DEFAULT_PIPELINE, parse_pipeline_spec
from repro_torch.core.precision import FP_5_4

log = obs.get_logger(__name__)


def build(ctx) -> None:
    # 1. describe the DNN operation as an scf-style loop nest
    x = ctx.memref("input", (1, 3, 16, 16), "input")
    w = ctx.memref("weight", (8, 3, 3, 3), "weight")
    b = ctx.memref("bias", (8,), "weight")
    out = ctx.memref("out", (1, 8, 14, 14), "output")
    frontend.conv2d(ctx, x, w, b, out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pipeline", default=None, metavar="P1,P2,...",
                    help="comma-separated pass pipeline "
                         f"(default: {','.join(DEFAULT_PIPELINE)})")
    ap.add_argument("--device", default="cuda",
                    help="where the design runs (default: cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    obs.setup_logging()
    try:
        config = hls.CompilerConfig() if args.pipeline is None else \
            hls.CompilerConfig(pipeline=parse_pipeline_spec(args.pipeline))
    except ValueError as e:
        raise SystemExit(str(e))

    # 2. compile: trace -> passes -> schedule, one public entrypoint
    design = hls.compile(build, name="conv2d_quickstart", config=config,
                         device=args.device)
    log.info("%s", design.report())

    # 3. one behavioural testbench covers it all (§3.2): optimised DFG and
    # emitted SIMD design vs the interpreter reference, plus the FloPoCo
    # (5,4) functional model
    report = design.verify(batch=4, seed=0, fmt=FP_5_4)
    log.info("%s", report.summary())
    log.info("(5,4) max abs deviation vs fp32: %.4f",
             report.max_abs_err_quant)
    if not report.passed:
        raise RuntimeError(f"behavioural verification failed: "
                           f"{report.summary()}")
    log.info("emitted SIMD design matches the functional "
             "simulation  [OK]")

    # 4. the deployable path: run a fresh batch through the kernels
    fn = design.torch_fn()
    feeds = verify.random_feeds(design.graph_opt, batch=4, seed=1)
    got = fn(feeds)["out"]
    want = design.run(feeds)["out"]
    np.testing.assert_allclose(got.cpu().numpy().reshape(want.shape), want,
                               rtol=1e-4, atol=1e-5)
    log.info("served a batch of 4 through the %s tier on %s: out %s, equal "
             "to the functional model", fn.plan.mode, got.device,
             tuple(got.shape))

    # 5. a second compile of the same program is a cache hit
    hls.compile(build, name="conv2d_quickstart", config=config,
                session=design.session)
    stats = design.session.stats()
    log.info("design cache: %s hit(s), %s miss(es), hash %s",
             stats["hits"], stats["misses"], design.design_hash[:12])


if __name__ == "__main__":
    main()
