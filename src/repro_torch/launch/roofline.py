"""Three-term roofline from the dry-run's records, and the machine constants
of the card the port serves on.  The reference's ``repro.launch.roofline``
for the port.

The card is one NVIDIA H100 SXM5 80GB, from NVIDIA's data sheet, at the
card's full 700 W power limit (a card set below it runs slower under load):

* ``PEAK_FLOPS`` — 67 TFLOP/s in float32 on the CUDA cores, outside the
  tensor cores: the rate of the fp32 FMA accumulation the port's kernels
  keep; the tuner's dry cost model (``tune.evaluator``) reads it;
* ``PEAK_BF16`` — 989 TFLOP/s dense bf16 on the tensor cores, the roof of
  the LMs' bf16 matmuls (fp32 sums);
* ``HBM_BW`` — 3.35 TB/s of HBM3, and ``HBM_BYTES``, its 80 GB;
* the links: NVLink 4 at 450 GB/s each way to the other 7 cards of an
  8-card node, and 400 Gb/s (50 GB/s) of InfiniBand per card between
  nodes.  A 256-card mesh spans 32 nodes of 8: on the single-pod mesh a
  ``model`` group of 16 ranks spans 2 nodes and a ``data`` group 16, so
  both cross InfiniBand.

Terms per (arch x shape) cell, per device:

  compute term    = traced FLOPs / 989 TFLOP/s
  memory term     = HBM bytes / 3.35 TB/s (the model below)
  collective term = wire bytes over NVLink / 450 GB/s + wire bytes over
                    InfiniBand / 50 GB/s (each collective by the nodes
                    its group spans)

Sources: the FLOPs are ``FlopCounterMode``'s count of one traced step
(matmuls, convolutions, attention; no elementwise op), the wire bytes the
op inventory's (``launch.op_inventory``), both from ``launch.dryrun``.  The
HBM bytes come from an analytic traffic model of what the port's step
moves (:func:`memory_bytes_cell`), gathered parameters included where the
gather plan gathers them.
MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); the ratio
MODEL_FLOPS / traced FLOPs exposes remat, dispatch and attention overheads.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

PEAK_FLOPS = 67e12         # float32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12         # dense bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12           # bytes/s of HBM3
HBM_BYTES = 80e9           # bytes of HBM3 per card
NVLINK_BW = 450e9          # bytes/s each way, to the cards of one node
IB_BW = 50e9               # bytes/s of InfiniBand (400 Gb/s) per card
CARDS_PER_NODE = 8
CHIPS_SINGLE = 256


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float            # global, analytic
    traced_flops: float           # global = per-device x chips
    params_bytes_per_device: float
    peak_bytes: float = 0.0       # per device, the traced step's
    notes: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.traced_flops if self.traced_flops \
            else 0.0

    @property
    def fits(self) -> bool:
        return self.peak_bytes <= HBM_BYTES

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's bf16 roof achieved at the modelled bound:
        (useful model FLOPs / chips / bound_time) / peak."""
        if self.bound_time <= 0:
            return 0.0
        per_chip = self.model_flops / CHIPS_SINGLE
        return (per_chip / self.bound_time) / PEAK_BF16


# ---------------------------------------------------------------------------
# analytic models
# ---------------------------------------------------------------------------

def _config(arch: str, cfg=None):
    from repro_torch.configs import registry
    return cfg or registry.get_config(arch)


def model_flops_cell(arch: str, shape_name: str, cfg=None) -> float:
    """Global MODEL_FLOPS for one step of the cell (6ND train, 2N_active
    per generated token for decode, 2ND prefill)."""
    from repro_torch.configs import registry
    from repro_torch.models import encdec
    from repro_torch.models import lm as lm_lib
    from repro_torch.nn import module as module_lib
    cfg = _config(arch, cfg)
    shape = registry.get_shape(shape_name)
    if cfg.is_encoder_decoder:
        per_token_train = 6.0 * module_lib.param_count(
            encdec.model_specs(cfg))
    else:
        per_token_train = lm_lib.model_flops_per_token(cfg)   # 6N
    n_active_2x = per_token_train / 3.0                       # 2N
    if shape.kind == "train":
        return per_token_train * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return n_active_2x * shape.global_batch * shape.seq_len
    return n_active_2x * shape.global_batch     # decode: one token each


def memory_bytes_cell(arch: str, shape_name: str, rec: dict,
                      cfg=None) -> float:
    """Per-device HBM traffic of one call of the port's sharded step
    (``launch.steps``), in bytes.

    A train step:

    * weights, fp32 (P elements the compute reads, P_l of them in this
      rank's blocks; P is the whole count under the gather plan, P_l
      under the split plan, ``model_split`` "compute"): the gather writes
      the whole buffer and the scatter writes and reads it again (3·P;
      the split plan gathers nothing and its scatter writes the local
      blocks, P_l), each microbatch reads it three times (the forward, its
      recompute under remat, the backward) and adds into the fp32 gradient
      (3·P per microbatch); the all-reduce reads and writes the gradient
      (2·P); AdamW reads the parameter, gradient and both moments of its
      blocks and writes three (7·P_l); 4 bytes each;
    * activations: the reference's model, 8 bf16 passes over each layer's
      (tokens, d) per step, the tokens this data rank holds.

    A prefill or a decode step, the reference's terms: the compute reads
    the weights once, in their serving dtype: the whole (gathered, once
    per parameter set) ``params_whole_bytes`` under the gather plan, this
    rank's ``params_bytes_per_device`` under the split plan; a prefill adds 4 bf16
    passes over each layer's (tokens, d), a decode step reads this rank's
    cache (``cache_bytes_per_device``, where the reference reads XLA's
    alias bytes) and writes each lane's new slot and reads its token's
    (lanes, d) in bf16.
    """
    from repro_torch.configs import registry
    cfg = _config(arch, cfg)
    shape = registry.get_shape(shape_name)
    dp = int(rec.get("data_ways", 16 if shape.global_batch % 16 == 0 else 1))
    tokens_local = shape.global_batch * shape.seq_len / dp
    split = rec.get("model_split") == "compute"
    read = float(rec.get("params_bytes_per_device" if split
                         else "params_whole_bytes", 0.0))
    if shape.kind == "prefill":
        return read + 4.0 * cfg.n_layers * tokens_local * cfg.d_model * 2.0
    if shape.kind == "decode":
        return read + float(rec.get("cache_bytes_per_device", 0.0)) + \
            2.0 * tokens_local / shape.seq_len * cfg.d_model * 2.0
    p_local = float(rec.get("params_bytes_per_device", 0.0)) / 4.0
    p_whole = p_local if split else \
        float(rec.get("params_whole_bytes", 0.0)) / 4.0 or p_local
    n_micro = max(1, int(rec.get("microbatches", cfg.microbatches)))
    gather = p_local if split else 3 * p_whole
    w_traffic = 4.0 * (gather + p_whole * (3 * n_micro + 2) + 7 * p_local)
    act_traffic = 8.0 * cfg.n_layers * tokens_local * cfg.d_model * 2.0
    return w_traffic + act_traffic


def collective_seconds(rec: dict) -> float:
    """The collective term of a record: its wire bytes over each link."""
    by_link = rec.get("collective_bytes_by_link", {})
    return by_link.get("nvlink", 0.0) / NVLINK_BW + \
        by_link.get("infiniband", 0.0) / IB_BW


def load_cells(dryrun_dir: str = "experiments/dryrun_torch",
               mesh: str = "single") -> list[RooflineRow]:
    rows = []
    for path in sorted(pathlib.Path(dryrun_dir).glob(f"*__{mesh}.json")):
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok":
            continue
        arch, shape_name = rec["arch"], rec["shape"]
        flops_dev = float(rec["flops_per_device"])
        rows.append(RooflineRow(
            arch=arch, shape=shape_name,
            compute_s=flops_dev / PEAK_BF16,
            memory_s=memory_bytes_cell(arch, shape_name, rec) / HBM_BW,
            collective_s=collective_seconds(rec),
            model_flops=model_flops_cell(arch, shape_name),
            traced_flops=flops_dev * CHIPS_SINGLE,
            params_bytes_per_device=rec.get("params_bytes_per_device", 0),
            peak_bytes=rec["memory"]["peak_bytes"]))
    return rows


_MOVE_HINTS = {
    "compute": ("raise the useful share of the FLOPs (fewer recomputes, "
                "K5 on the tensor cores, less MoE dispatch padding)"),
    "memory": ("cut HBM traffic: keep the bf16 weight copy per step, not "
               "per call; shard the compute over model (tensor parallel) "
               "instead of gathering whole weights"),
    "collective": ("reduce-scatter the gradients into their blocks instead "
                   "of all-reducing whole ones; bf16 reductions; keep the "
                   "model axis inside a node"),
}


def to_markdown(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL_FLOPS | useful ratio | roofline frac | "
           "peak GB | fits | what moves the bound |\n|" + "---|" * 12)
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.4f} | "
            f"{r.memory_s:.4f} | {r.collective_s:.4f} | **{r.dominant}** | "
            f"{r.model_flops:.3e} | {r.useful_ratio:.2f} | "
            f"{r.roofline_fraction:.3f} | {r.peak_bytes / 1e9:.1f} | "
            f"{'yes' if r.fits else 'no'} | {_MOVE_HINTS[r.dominant]} |")
    return "\n".join(lines)


def serving_table(dryrun_dir: str = "experiments/dryrun_torch",
                  mesh: str = "single") -> str:
    """The prefill and decode records of ``mesh`` (tagged variants too) as
    a markdown table: per device, the peak, whether it fits, the FLOPs,
    the cache (the port's; the rules') and the one-time gather, the
    kernels' launches and the trace's seconds."""
    hdr = ("| arch | shape | tag | peak GB | fits | TFLOP | cache GB "
           "(rules') | gather GB | launches | trace s |\n|" + "---|" * 10)
    lines = [hdr]
    for path in sorted(pathlib.Path(dryrun_dir).glob(f"*__{mesh}*.json")):
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok" or "gather_bytes_per_device" not in rec:
            continue
        launches = ", ".join(f"{k} {v}" for k, v in
                             sorted(rec["kernel_launches"].items())) or "-"
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {rec.get('tag') or '-'} | "
            f"{rec['memory']['peak_bytes'] / 1e9:.2f} | "
            f"{'yes' if rec['fits'] else 'no'} | "
            f"{rec['flops_per_device'] / 1e12:.2f} | "
            f"{rec['cache_bytes_per_device'] / 1e9:.2f} "
            f"({rec['cache_bytes_per_device_rules'] / 1e9:.2f}) | "
            f"{rec['gather_bytes_per_device'] / 1e9:.2f} | {launches} | "
            f"{rec['trace_s']} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--serving", action="store_true",
                    help="the prefill and decode cells' table instead")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    if args.serving:
        print(serving_table(args.dir, args.mesh))
    else:
        print(to_markdown(load_cells(args.dir, args.mesh)))


if __name__ == "__main__":
    main()
