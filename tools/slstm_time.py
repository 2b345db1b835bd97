"""Time the sLSTM kernels (``csrc/slstm_scan.cu``, and
``csrc/slstm_scan_backward.cu`` where the tree has it) of one source tree
on the card.

    python3 tools/slstm_time.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree whose ``repro_torch`` is
timed (default: this checkout's), so two commits compare on one card
back to back: unpack the other commit with ``git archive`` into a
directory that ``.gitignore`` lists and run the script on both trees in
turn (A, B, B, A).  The forward is timed at xlstm-1.3b's serving calls
(the prefill's, B 4 x S 1,024 from the init state; the tick's, B 8 x S 1
from a drawn state) with no saves, and at its training call (B 1 x S
1,024) with and without the saves where the tree's wrapper takes them;
the backward at the training call.  Each call is timed with
``chip_smoke.device_ms``, the method of the smoke's kernel rows.  Prints
one JSON line: the label, the tree, the card's name and power limit, the
kernels' registers and spills from ``ptxas -v`` where this process
compiled them, and ms per call.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: xlstm-1.3b's sLSTM: heads and head width
HEADS, WIDTH = 4, 512
#: (label, batch rows, steps, start from the init state, timed runs)
CALLS = (("prefill", 4, 1024, True, 20), ("tick", 8, 1, False, 120),
         ("train", 1, 1024, True, 20))


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
        print("slstm_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.slstm_scan import slstm_scan as mod

    build.library()
    regs, fn, spills = [], "", ""
    for ln in build.info.log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln and "slstm" in fn:
            regs.append(f"{fn}: {ln.split(':', 1)[1].strip()}; {spills}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    takes_saves = "saves" in inspect.signature(mod.slstm_scan).parameters
    backward = getattr(mod, "slstm_scan_backward", None)
    gen = torch.Generator(device="cuda").manual_seed(21)
    times = {}
    for label, b, s, init, runs in CALLS:
        x_pre = [torch.randn(b, s, HEADS, WIDTH, generator=gen,
                             device="cuda") for _ in range(4)]
        rec = [0.02 * torch.randn(HEADS, WIDTH, WIDTH, generator=gen,
                                  device="cuda") for _ in range(4)]
        if init:
            state = [torch.zeros(b, HEADS, WIDTH, device="cuda")
                     for _ in range(3)]
            state.append(torch.full((b, HEADS, WIDTH), -1e30,
                                    device="cuda"))
        else:
            state = [torch.randn(b, HEADS, WIDTH, generator=gen,
                                 device="cuda") for _ in range(4)]
            state[2] = state[2].abs() + 1.0
        call = f"{label} (B {b}, S {s}, H {HEADS}, W {WIDTH})"
        times[call] = chip_smoke.device_ms(
            torch, lambda: mod.slstm_scan(x_pre, rec, *state), runs=runs,
            label=call)
        if label != "train" or not takes_saves:
            continue
        saves = [torch.empty_like(x_pre[0]) for _ in mod.SAVES]
        times[f"{call} with saves"] = chip_smoke.device_ms(
            torch, lambda: mod.slstm_scan(x_pre, rec, *state, saves=saves),
            runs=runs, label=call)
        if backward is not None:
            dhs = torch.randn_like(x_pre[0])
            times[f"{call} backward"] = chip_smoke.device_ms(
                torch, lambda: backward(dhs, rec, saves, *state[1:]),
                runs=runs, label=call)
    print(json.dumps({"label": args.label, "src": str(src),
                      "card": smi.strip(),
                      "compiled_here": build.info.compiled,
                      "ptxas_registers": regs, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
