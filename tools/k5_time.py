"""Time the flash-attention kernel (K5) of one source tree on the card.

    python3 tools/k5_time.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so two commits compare on one card
back to back: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script on both trees in
turn (A, B, B, A).  Each shape is timed with ``chip_smoke.device_ms``, the
method of the smoke's kernel rows.  Prints one JSON line: the label, the
tree, the card's name and power limit, the kernel's registers and spills
from ``ptxas -v`` where this process compiled it, and ms per shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (B*H, S, D, options, timed runs): the prefill shapes of the smoke's K5
#: rows (Qwen2.5-3B, gemma2's local options, RecurrentGemma-9b at D 256,
#: whisper-tiny's encoder)
SHAPES = ((64, 1024, 128, {"causal": True}, 120),
          (64, 333, 128, {"causal": True, "window": 128,
                          "logit_cap": 50.0}, 120),
          (32, 4096, 256, {"causal": True, "window": 2048}, 30),
          (48, 1500, 64, {"causal": False}, 120))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("k5_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention

    build.library()
    # ptxas -v, as the smoke's phase build reads it: each flash-attention
    # entry function's registers and spills
    regs, fn, spills = [], "", ""
    for ln in build.info.log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln and "flash_attention" in fn:
            regs.append(f"{fn}: {ln.split(':', 1)[1].strip()}; {spills}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    gen = torch.Generator(device="cuda").manual_seed(20)
    times = {}
    for bh, s, d, kw, runs in SHAPES:
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   for _ in range(3))
        call = f"({bh}, {s}, {d}) " + ",".join(f"{a}={b}"
                                              for a, b in kw.items())
        times[call] = chip_smoke.device_ms(
            torch, lambda: flash_attention(q, k, v, **kw), runs=runs,
            label=call)
        del q, k, v
    print(json.dumps({"label": args.label, "src": str(src),
                      "card": smi.strip(),
                      "compiled_here": build.info.compiled,
                      "ptxas_registers": regs, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
