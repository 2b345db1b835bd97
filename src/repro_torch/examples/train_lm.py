"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
through the full stack (pipeline -> train step -> checkpoints ->
fault-tolerant driver), with a failure injected half way through to show
the checkpoint restart.

    python -m repro_torch.examples.train_lm [--steps 200]   # on the card
    python -m repro_torch.examples.train_lm --device cpu --steps 4 \\
        --batch 2 --seq 32

The reference's ``examples/train_lm.py``: lm-100m (8 layers, d_model 768,
GQA 12/4, 32k vocabulary, full remat), AdamW with 20 warm-up steps,
checkpoints every 50 steps.  The step updates in place and, on the card,
replays its captured CUDA graph.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import obs
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.nn import module, transformer
from repro_torch.optim import adamw
from repro_torch.runtime.fault import DriverConfig, FailureInjector, \
    TrainingDriver

log = obs.get_logger(__name__)

#: ~100M params: 8L x d768 GQA + gated MLP + 32k vocab
CONFIG = ModelConfig(
    name="lm-100m", family="dense", n_layers=8, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32768,
    attn_pattern=("global",), head_dim=64, attn_block_size=256,
    remat="full")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    obs.setup_logging()
    dev = resolve(args.device)

    cfg = CONFIG
    specs = transformer.model_specs(cfg)
    log.info("model: %.1fM params on %s", module.param_count(specs) / 1e6,
             dev)
    params = module.init_tree(specs, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    opt = adamw.init_state(params)
    step = make_train_step(cfg, adamw.AdamWConfig(
        peak_lr=1e-3, warmup_steps=20, total_steps=args.steps))
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size))
    driver = TrainingDriver(
        DriverConfig(total_steps=args.steps, checkpoint_every=50),
        train_step=step, pipeline=pipe,
        ckpt=CheckpointManager(args.ckpt, keep=2),
        injector=FailureInjector((args.steps // 2,)))   # mid-run crash

    t0 = time.monotonic()
    report = driver.run(params, opt)
    dt = time.monotonic() - t0
    toks = args.steps * args.batch * args.seq
    log.info("done: %s steps, %.0f tok/s, restarts=%s (1 injected), "
             "stragglers=%s", args.steps, toks / dt, report.restarts,
             len(report.straggler_steps))
    log.info("loss: %.3f -> %.3f (next-token CE on synthetic Zipf stream)",
             report.losses[0], report.losses[-1])
    assert report.restarts == 1 and report.losses[-1] < report.losses[0]
    return report


if __name__ == "__main__":
    main()
