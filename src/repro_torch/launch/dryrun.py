"""Dry-run: trace one step of every (architecture x shape x mesh) on a fake
world of the production mesh's ranks.  The reference's
``repro.launch.dryrun`` for the port.

For every supported cell this module:

1. builds the parameters, the AdamW state and the inputs as fake tensors
   (``FakeTensorMode``: shapes and dtypes, no storage), laid out as DTensor
   blocks by the binding rules, on a fake world of 256 (512) ranks
   (``launch.mesh.fake_world``), this process rank 0 of it;
2. runs the port's train step (``make_train_step(...).eager``) once, under
   ``FlopCounterMode``, ``MemTracker`` and the op inventory
   (``launch.op_inventory``): rank 0's share of the work, collectives that
   return at once, kernels that launch nothing;
3. records the FLOPs per device, the peak of the bytes live per device
   against the card's 80 GB, the collectives by kind with the reference's
   wire-byte model, and each kernel's launches;
4. writes one JSON per cell under ``experiments/dryrun_torch/``.

On the card's machine the tensors are fake CUDA tensors, so each kernel is
reached as its custom op (its fake implementation) and counted; on the CPU
(``--device cpu``) they are fake CPU tensors, and each kernel's wrapper
takes its plain version, whose matmuls the FLOP count then holds instead.

What the reference records and an eager trace cannot: XLA's lowering and
compile seconds, its generated code, alias and temp bytes, its loops and
their trip counts (see ``op_inventory``).  The record has ``trace_s``, the
seconds of the traced step, in their place, and ``peak_bytes``, the most
bytes live on the device at once (the arguments included), where XLA
gives temp bytes.  What it shows of the port: the port's sharded step is data
parallel (``launch.steps``), gathering every split parameter into a whole
buffer, so a large model's peak can exceed 80 GB where the reference's
tensor-parallel program fits: that is the finding, not a fault of the
dry-run.  Prefill and decode cells are not run: the port shards only the
train step (ROADMAP.md queue 1 item 8.8).

Usage::

    python -m repro_torch.launch.dryrun --arch all --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh single --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig, supports_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch.op_inventory import OpInventory
from repro_torch.launch.roofline import HBM_BYTES
from repro_torch.launch.steps import make_train_step
from repro_torch.nn import module as module_lib
from repro_torch.optim import adamw

OUT_DIR = "experiments/dryrun_torch"
#: why a prefill or decode cell is not run
NOT_SHARDED = ("the port shards only the train step: data-parallel "
               "prefill and decode on a mesh are ROADMAP.md queue 1 item 8.8")
#: the production meshes' shapes
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_shape(mesh_kind: Union[str, dict]) -> tuple[tuple, tuple, str]:
    """(sizes, axis names, the record's name) of a production mesh
    ("single", "multi") or of a mesh given as {axis: size}."""
    if isinstance(mesh_kind, str):
        return (*MESHES[mesh_kind], mesh_kind)
    return (tuple(mesh_kind.values()), tuple(mesh_kind),
            "x".join(map(str, mesh_kind.values())))


def _specs(cfg):
    from repro_torch.models import encdec
    from repro_torch.nn import transformer
    return encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        transformer.model_specs(cfg)


def build_cell(arch: str, shape_name: str, mesh, *, cfg=None,
               shape: Optional[ShapeConfig] = None, device="cuda"):
    """(step, (params, opt_state, batch), (param, state, input shardings),
    the config with its mesh-aware microbatches) of a train cell: the fake
    tensors made in the caller's ``FakeTensorMode`` on ``device``, the
    parameters and state as DTensor blocks on ``mesh``.  ``shape``
    overrides the registry's shape (a tiny cell)."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or registry.get_shape(shape_name)
    if shape.kind != "train":
        raise NotImplementedError(NOT_SHARDED)
    rules = sh.rules_for(cfg)
    # mesh-aware: the per-microbatch batch must stay divisible by the
    # data-parallel ways, else the batch is not split over them
    n_micro = max(1, cfg.microbatches)
    dp_ways = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    while n_micro > 1 and (shape.global_batch // n_micro) % dp_ways:
        n_micro //= 2
    cfg = cfg.replace(microbatches=n_micro)

    abstract, param_sh = sh.model_param_shardings(cfg, mesh)
    axes = module_lib.axes_tree(_specs(cfg))
    opt_sh = sh.state_shardings(abstract, axes, mesh, rules)
    inputs = registry.input_specs(cfg, shape)
    in_axes = registry.input_axes(cfg, shape)
    input_sh = {k: sh.sharding_for(tuple(v.shape), in_axes[k], mesh, rules)
                for k, v in inputs.items()}
    micro_sh = None
    if n_micro > 1:
        micro_sh = {
            k: sh.sharding_for(
                (n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]),
                (None,) + tuple(in_axes[k]), mesh, rules)
            for k, v in inputs.items()}

    def fake(a):
        return torch.zeros(a.shape, dtype=a.dtype, device=device)
    whole = module_lib.map_tree(fake, abstract)
    params = sh.shard_tree(whole, param_sh)
    opt_state = sh.shard_tree(adamw.init_state(whole), opt_sh)
    batch = {k: fake(v) for k, v in inputs.items()}
    step = make_train_step(cfg, microbatch_shardings=micro_sh,
                           grad_shardings=opt_sh["mu"])
    return step, (params, opt_state, batch), (param_sh, opt_sh, input_sh), \
        cfg


def _batch_split(cfg, shape: ShapeConfig, mesh) -> bool:
    """Whether each microbatch's rows split over the data axes."""
    per = shape.global_batch // max(1, cfg.microbatches)
    entry = sh.prune_spec((per,), sh.rules_for(cfg).spec(("batch",), mesh),
                          mesh)[0]
    return entry is not None


def _bmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """A batched product's FLOPs, for each of ``aten.bmm``'s overloads:
    ``bmm.dtype`` (the MoE's expert products, bf16 operands to an fp32
    result) passes its dtype positionally, which torch 2.11's own formula
    does not take."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def _local_bytes(tree) -> int:
    return sum(sh.local(t).numel() * t.element_size()
               for t in module_lib.tree_leaves(tree))


def run_cell(arch: str, shape_name: str, mesh_kind: Union[str, dict],
             out_dir: pathlib.Path, *, cfg=None, tag: str = "",
             shape: Optional[ShapeConfig] = None, device="cuda") -> dict:
    """Trace one cell on a fake world of ``mesh_kind``'s ranks (a
    production mesh's name, or {axis: size}) and write its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    shape = shape or registry.get_shape(shape_name)
    base_cfg = cfg or registry.get_config(arch)
    sizes, axes, mesh_name = _mesh_shape(mesh_kind)
    ok, why = supports_shape(base_cfg, shape)
    if ok and shape.kind != "train":
        ok, why = False, NOT_SHARDED
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "supported": ok, "skip_reason": why, "tag": tag,
           "device": torch.device(device).type}
    if not ok:
        return _write(rec, out_dir, arch, shape_name, mesh_name, tag)
    t0 = time.perf_counter()
    try:
        with mesh_lib.fake_world(sizes, axes, device) as mesh, \
                FakeTensorMode():
            step, args, shardings, cell_cfg = build_cell(
                arch, shape_name, mesh, cfg=base_cfg, shape=shape,
                device=device)
            params, opt_state, batch = args
            tracker = MemTracker()
            tracker.track_external(*(sh.local(t) for t in
                                      module_lib.tree_leaves(
                                          (params, opt_state))),
                                   *batch.values())
            inventory = OpInventory()
            flops = FlopCounterMode(display=False, custom_mapping={
                torch.ops.aten.bmm: _bmm_flops})
            with tracker, flops, inventory:
                _, _, metrics = step.eager(params, opt_state, batch)
            peak = tracker.get_tracker_snapshot("peak")
        report = inventory.report()
        peak_bytes = max(v["Total"] for v in peak.values())
        rec.update({
            "status": "ok",
            "trace_s": round(time.perf_counter() - t0, 2),
            "microbatches": cell_cfg.microbatches,
            "data_ways": mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
            if _batch_split(cell_cfg, shape, mesh) else 1,
            "memory": {
                "argument_bytes": _local_bytes((params, opt_state))
                + sum(t.numel() * t.element_size() for t in batch.values()),
                "output_bytes": sum(t.numel() * t.element_size()
                                    for t in metrics.values()),
                "peak_bytes": peak_bytes,
            },
            "params_bytes_per_device": sh.bytes_per_device(params,
                                                           shardings[0]),
            "params_whole_bytes": sum(
                math.prod(t.shape) * t.element_size()
                for t in module_lib.tree_leaves(params)),
            "flops_per_device": float(flops.get_total_flops()),
            "collective_bytes_per_device": report.collective_bytes,
            "collectives_by_kind": report.by_kind(),
            "collective_bytes_by_link": report.by_link(),
            "n_collective_ops": len(report.collectives),
            "kernel_launches": report.kernel_launches,
            "n_ops": report.n_ops,
            "fits": peak_bytes <= HBM_BYTES,
            "gaps": "no compiled program: lower_s, compile_s, code_bytes, "
                    "alias_bytes, temp_bytes, n_while, trip_counts and "
                    "hlo_chars have no counterpart; trace_s and peak_bytes "
                    "(the most bytes live at once, arguments included) "
                    "stand in their place",
        })
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec.update({"status": "error", "error": repr(e),
                    "traceback": traceback.format_exc()[-20000:]})
    return _write(rec, out_dir, arch, shape_name, mesh_name, tag)


def _write(rec: dict, out_dir: pathlib.Path, arch: str, shape_name: str,
           mesh_name: str, tag: str) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda: the kernels' "
                         "custom ops; cpu: their plain versions)")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    out_dir = pathlib.Path(args.out)

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") == "ok" or \
                            not prev.get("supported", True):
                        continue
                rec = run_cell(arch, shape_name, mesh_kind, out_dir,
                               device=args.device)
                if not rec.get("supported", True):
                    n_skip += 1
                    print(f"[skip] {arch} x {shape_name} x {mesh_kind}: "
                          f"{rec['skip_reason']}", flush=True)
                elif rec["status"] == "ok":
                    n_ok += 1
                    print(f"[ ok ] {arch} x {shape_name} x {mesh_kind}: "
                          f"trace {rec['trace_s']}s, "
                          f"TF/dev {rec['flops_per_device'] / 1e12:.3f}, "
                          f"collMB/dev "
                          f"{rec['collective_bytes_per_device'] / 1e6:.1f}, "
                          f"peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB"
                          f"{'' if rec['fits'] else ' (does not fit)'}",
                          flush=True)
                else:
                    n_err += 1
                    print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: "
                          f"{rec['error']}", flush=True)
    print(f"done: {n_ok} ok, {n_err} failed, {n_skip} skipped", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
