"""Serving launcher: the continuous-batching engine on a decoder LM.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --requests 8                      # the tiny config, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --no-tiny --requests 8            # the published width and depth
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --no-tiny  # the MoE family at full width
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --no-tiny  # RG-LRU + local attention
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch xlstm-1.3b --no-tiny       # mLSTM + sLSTM blocks
    ... --device cpu                      # on the CPU

Weights are drawn from a seeded generator on the device they serve from
(nothing is downloaded); prompts of 4-15 tokens come from another seeded
generator.  The config is the architecture's ``tiny()`` unless
``--no-tiny`` is given.  An encoder-decoder (whisper-tiny) is refused,
as the reference's launcher refuses it: its steps run through
``models/encdec``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.core.device import resolve
from repro_torch.nn import module as module_lib
from repro_torch.nn import transformer
from repro_torch.serving.engine import ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=registry.ARCH_IDS,
                    help="a ported architecture (default: qwen2.5-3b)")
    ap.add_argument("--tiny", action=argparse.BooleanOptionalAction,
                    default=True, help="the architecture's tiny() config "
                    "(default); --no-tiny serves the published one")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = registry.get_tiny(args.arch) if args.tiny \
        else registry.get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit("serve.py targets decoder-only archs")
    t0 = time.monotonic()
    params = module_lib.init_tree(
        transformer.model_specs(cfg),
        torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                           max_len=args.max_len)
    boot_s = time.monotonic() - t0

    gen = torch.Generator().manual_seed(1)
    for _ in range(args.requests):
        n = 4 + int(torch.randint(0, 12, (), generator=gen))
        prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
        engine.submit(prompt.tolist(), max_new_tokens=args.new_tokens)

    t0 = time.monotonic()
    finished = engine.run_until_drained()
    dt = time.monotonic() - t0
    s = engine.stats()
    print(f"[serve] {cfg.name} on {dev}: {s['requests']} requests, "
          f"{s['generated_tokens']} tokens in {dt:.1f}s "
          f"({s['generated_tokens'] / dt:.1f} tok/s, "
          f"{dt / max(s['ticks'], 1) * 1e3:.1f} ms/tick), "
          f"ttft={s['mean_ttft_s'] * 1e3:.0f}ms, boot {boot_s:.1f}s")
    if len(finished) != args.requests:
        raise SystemExit(f"{len(finished)} of {args.requests} requests "
                         f"finished within the engine's tick limit")
    return s


if __name__ == "__main__":
    main()
