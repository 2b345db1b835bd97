"""Continuous-batching serving of a (reduced) Mixtral-style MoE with SWA:
expert routing and the rolling-window KV cache through the public engine
API.

    python -m repro_torch.examples.serve_moe                # on the card
    python -m repro_torch.examples.serve_moe --device cpu

Tiny Mixtral (4 experts, top 2, window 8) with weights drawn from a seed
on the device it serves from; 10 requests of 3-12 prompt tokens and 12 new
tokens each over 4 lanes.  On the card each tick replays the decode step's
captured CUDA graph.
"""

import argparse
import time

import torch

from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.core.device import resolve
from repro_torch.nn import module, transformer
from repro_torch.serving.engine import ServingEngine

log = obs.get_logger(__name__)

N_REQUESTS, NEW_TOKENS, LANES = 10, 12, 4


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    obs.setup_logging()
    dev = resolve(args.device)
    cfg = registry.get_tiny("mixtral-8x7b")
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    engine = ServingEngine(cfg, params, max_batch=LANES, max_len=96)

    gen = torch.Generator().manual_seed(1)
    for _ in range(N_REQUESTS):
        n = 3 + int(torch.randint(0, 10, (), generator=gen))
        prompt = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
        engine.submit(prompt.tolist(), max_new_tokens=NEW_TOKENS)

    t0 = time.monotonic()
    finished = engine.run_until_drained()
    dt = time.monotonic() - t0
    s = engine.stats()
    log.info("%s on %s: %s requests / %s tokens in %.1fs "
             "(%.1f tok/s, %d lanes, continuous batching)",
             cfg.name, dev, s["requests"], s["generated_tokens"], dt,
             s["generated_tokens"] / dt, LANES)
    if len(finished) != N_REQUESTS or any(
            len(r.output) != NEW_TOKENS for r in finished):
        raise SystemExit(f"{len(finished)} of {N_REQUESTS} requests finished "
                         f"with {NEW_TOKENS} tokens each")
    log.info("sample output: %s", finished[0].output)
    return finished


if __name__ == "__main__":
    main()
