"""Training launcher: fault-tolerant LM training on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --tiny --steps 50 --batch 8 --seq 128     # the tiny config, on the card
    ... --device cpu                              # on the CPU

The reference's CLI (``repro.launch.train``): weights drawn from a seeded
generator on the device they train on, AdamW, the seekable synthetic
token pipeline, checkpoints every ``--ckpt-every`` steps and the
``TrainingDriver``'s restart after the failures ``--fail-at`` injects.
The step is ``launch.steps.make_train_step``'s: in place, replayed from a
captured CUDA graph on the card.  An encoder-decoder is refused, as the
reference refuses it.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import registry
from repro_torch.core.device import resolve
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.nn import module as module_lib
from repro_torch.nn import transformer
from repro_torch.optim import adamw, compress
from repro_torch.runtime.fault import DriverConfig, FailureInjector, \
    TrainingDriver


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-7b", choices=registry.ARCH_IDS)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (restart demo)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = registry.get_tiny(args.arch) if args.tiny \
        else registry.get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("train.py targets decoder-only archs (an "
                         "encoder-decoder's step: launch.steps."
                         "make_train_step)")

    specs = transformer.model_specs(cfg)
    print(f"[train] arch={cfg.name} params={module_lib.param_count(specs):,}"
          f" on {dev}")
    params = module_lib.init_tree(
        specs, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_state = adamw.init_state(params)
    if args.grad_compression:
        opt_state["err"] = compress.init_error_state(params)

    opt_cfg = adamw.AdamWConfig(total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg,
                              grad_compression=args.grad_compression)
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    driver = TrainingDriver(
        DriverConfig(total_steps=args.steps,
                     checkpoint_every=args.ckpt_every),
        train_step=step_fn, pipeline=pipe, ckpt=ckpt,
        injector=FailureInjector(tuple(args.fail_at)))

    t0 = time.monotonic()
    report = driver.run(params, opt_state)
    dt = time.monotonic() - t0
    toks = args.steps * args.batch * args.seq
    print(f"[train] done: {args.steps} steps in {dt:.1f}s "
          f"({toks / dt:.0f} tok/s), restarts={report.restarts}, "
          f"stragglers={len(report.straggler_steps)}")
    print(f"[train] loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    return report


if __name__ == "__main__":
    main()
