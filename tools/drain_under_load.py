"""Time the request engine's CPU dispatches on all intra-op threads and on
one, alone and beside busy processes.

    python3 tools/drain_under_load.py [--busy 5] [--repeats 2]
                                      [--batches 1,2,4,8,16,32,64]

Two measurements on BraggNN(s=1, img=``--img``, default 7)'s ``tensor`` runner, each made
once alone and once beside ``--busy`` processes that keep torch's CPU
kernels (convolutions and matrix products, every intra-op thread)
running:

- the runner's ms per batch at each of ``--batches``, on the whole
  intra-op pool and on one thread (``core.device.host_threads`` with its
  cutoff set either side of the batch).  Where the two cross alone is
  where ``SERIAL_CPU_BATCH`` belongs;
- what ``tests/test_torch_serving.py::test_queue_depth_counts_idle_and_ramp_periods``
  does: 8 single-sample requests queued with buckets (1,), 0.25 s
  asleep, then ``run_until_drained``, with the engine as it ships.

Prints one JSON line: the CPU count, the pool's size, per case the ms per
batch, and per drain its seconds, its compute seconds and the
time-weighted mean queue depth.  A CPU measurement: it says nothing of
the card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20


def _busy() -> None:
    """Keep torch's CPU kernels busy until terminated."""
    import torch
    a = torch.randn(256, 256)
    w = torch.randn(16, 16, 3, 3)
    while True:
        torch.nn.functional.conv2d(torch.randn(8, 16, 32, 32), w)
        a @ a


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--busy", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--batches", default="1,2,4,8,16,32,64")
    ap.add_argument("--img", type=int, default=7)
    args = ap.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch import hls
    from repro_torch.core import device as devices
    from repro_torch.models import braggnn
    from repro_torch.nn import module

    params = module.init_tree(braggnn.specs(1, args.img),
                              torch.Generator().manual_seed(0))
    design = hls.Session(device="cpu").compile(
        braggnn.build(1, args.img, params=params), name="drain")
    run, _, _ = design._runner("tensor", None, design.device, {})
    rng = np.random.default_rng(0)
    xs = [rng.normal(0.0, 0.25, (1, 1, args.img, args.img)).astype(np.float32)
          for _ in range(8)]
    pool = torch.get_num_threads()

    def per_batch() -> dict:
        out = {}
        for _ in range(args.repeats):
            for b in batches:
                x = np.zeros((b, 1, args.img, args.img), np.float32)
                for label, cut in ((f"{pool} threads", 0),
                                   ("1 thread", b + 1)):
                    with devices.host_threads(design.device, b, cut):
                        for _ in range(3):
                            run(x)
                        t0 = time.perf_counter()
                        for _ in range(REPS):
                            run(x)
                        ms = (time.perf_counter() - t0) / REPS * 1e3
                    out.setdefault(f"batch {b}", {}).setdefault(
                        label, []).append(ms)
        return out

    def drains() -> list:
        out = []
        for _ in range(args.repeats):
            eng = design.engine(backend="tensor", buckets=(1,))
            for x in xs:
                eng.submit(x)
            time.sleep(0.25)
            t0 = time.perf_counter()
            eng.run_until_drained()
            rep = eng.report()
            out.append({"drain_s": time.perf_counter() - t0,
                        "compute_s": rep.compute_s,
                        "mean_queue_depth": rep.mean_queue_depth})
        return out

    results = {"alone": {"ms_per_batch": per_batch(), "drains": drains()}}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_busy)
             for _ in range(args.busy)]
    for p in procs:
        p.start()
    try:
        time.sleep(3.0)                 # let them reach their loops
        results[f"beside {args.busy} busy processes"] = {
            "ms_per_batch": per_batch(), "drains": drains()}
    finally:
        for p in procs:
            p.terminate()
            p.join(timeout=60)
    print(json.dumps({"cpus": os.cpu_count(), "threads": pool,
                      "serial_cpu_batch": devices.SERIAL_CPU_BATCH,
                      **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
