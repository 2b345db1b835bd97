"""Hill-climbing: run tagged config variants of three chosen cells
through the dry-run, so every hypothesis -> change -> measure cycle leaves
a JSON record beside its baseline.  The reference's
``repro.launch.hillclimb`` for the port, with the same cells and variants.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe_train
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell all

The sweep loop (ordered tagged variants, skip where a record exists) is
``repro_torch.tune.strategies.sweep_variants``.  ``rg_long`` is a decode
cell (batch 1, so every data rank serves the whole batch): its variants
cast the parameters to bf16 (``serve_dtype``) and quantise the products
(``quant_format``).  Of the train variants' fields the port's step reads
``bf16_reduce``, ``remat``, ``microbatches``, ``capacity_factor`` and
``moe_token_chunks``; ``seq_shard_train`` binds no sequence axis in the
port's data-parallel step, so its variants trace as their base.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import registry

OUT_DIR = "experiments/dryrun_torch"


def _variants_stablelm_train():
    """Most collective-bound cell of the reference: stablelm-3b train_4k."""
    base = registry.get_config("stablelm-3b")
    return "stablelm-3b", "train_4k", [
        ("bf16reduce", base.replace(bf16_reduce=True)),
        ("dotsremat", base.replace(remat="dots")),
        ("sp", base.replace(seq_shard_train=True)),
        ("bf16reduce_dots", base.replace(bf16_reduce=True, remat="dots")),
        ("bf16reduce_sp", base.replace(bf16_reduce=True,
                                       seq_shard_train=True)),
        ("bf16reduce_sp_dots", base.replace(
            bf16_reduce=True, seq_shard_train=True, remat="dots")),
        ("dots_mb8", base.replace(remat="dots", microbatches=8)),
        ("dots_mb8_sp", base.replace(remat="dots", microbatches=8,
                                     seq_shard_train=True)),
    ]


def _variants_rg_long():
    """recurrentgemma-9b long_500k: low-latency inference bound by weight
    streaming (a decode cell)."""
    base = registry.get_config("recurrentgemma-9b")
    return "recurrentgemma-9b", "long_500k", [
        ("bf16serve", base.replace(serve_dtype="bfloat16")),
        ("bf16serve_q54", base.replace(serve_dtype="bfloat16",
                                       quant_format="5_4")),
    ]


def _variants_moe_train():
    """qwen2-moe-a2.7b train_4k: dispatch and shared experts on top of a
    small active core."""
    base = registry.get_config("qwen2-moe-a2.7b")
    return "qwen2-moe-a2.7b", "train_4k", [
        ("bf16reduce", base.replace(bf16_reduce=True)),
        ("cap10", base.replace(capacity_factor=1.0)),
        ("chunk8", base.replace(moe_token_chunks=8)),
        ("bf16reduce_cap10", base.replace(bf16_reduce=True,
                                          capacity_factor=1.0)),
        ("cap10_dots", base.replace(capacity_factor=1.0, remat="dots")),
        ("cap10_mb8", base.replace(capacity_factor=1.0, microbatches=8)),
        ("cap10_dots_mb8", base.replace(capacity_factor=1.0, remat="dots",
                                        microbatches=8)),
    ]


CELLS = {
    "stablelm_train": _variants_stablelm_train,
    "rg_long": _variants_rg_long,
    "moe_train": _variants_moe_train,
}


def summarize(out_dir: pathlib.Path, arch: str, shape: str,
              mesh: str = "single") -> None:
    from repro_torch.launch import roofline as rl
    rows = []
    for p in sorted(out_dir.glob(f"{arch}__{shape}__{mesh}*.json")):
        d = json.loads(p.read_text())
        tag = d.get("tag") or "baseline"
        if not d.get("supported", True):
            rows.append((tag, d["skip_reason"]))
        elif d.get("status") != "ok":
            rows.append((tag, "FAILED"))
        else:
            rows.append((tag, d["flops_per_device"] / rl.PEAK_BF16,
                         rl.collective_seconds(d),
                         d["memory"]["peak_bytes"] / 1e9))
    print(f"\n== {arch} x {shape} ==")
    print(f"{'variant':24s} {'compute_s':>10s} {'coll_s':>10s} "
          f"{'peakGB':>8s}")
    for tag, *vals in rows:
        if len(vals) == 1:
            print(f"{tag:24s}  {vals[0]}")
        else:
            c, link, peak = vals
            print(f"{tag:24s} {c:10.4f} {link:10.4f} {peak:8.2f}")


def main(argv=None) -> None:
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.tune.strategies import sweep_variants
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all", choices=list(CELLS) + ["all"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    names = list(CELLS) if args.cell == "all" else [args.cell]
    for name in names:
        arch, shape, variants = CELLS[name]()
        if not args.summarize_only:
            def already_ok(tag, cfg):
                path = out_dir / f"{arch}__{shape}__single__{tag}.json"
                return path.exists() and \
                    json.loads(path.read_text()).get("status") == "ok"

            def run_one(tag, cfg):
                rec = run_cell(arch, shape, "single", out_dir, cfg=cfg,
                               tag=tag, device=args.device)
                print(f"[{rec.get('status', 'skipped')}] {arch} x {shape} "
                      f"[{tag}]{'' if rec['supported'] else ': '}"
                      f"{rec['skip_reason']}", flush=True)
                return rec

            sweep_variants(variants, run_one, skip=already_ok)
        summarize(out_dir, arch, shape)


if __name__ == "__main__":
    main()
