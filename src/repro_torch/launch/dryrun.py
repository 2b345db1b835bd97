"""Dry-run: trace one step of every (architecture x shape x mesh) on a fake
world of the production mesh's ranks.  The reference's
``repro.launch.dryrun`` for the port.

For every supported cell this module:

1. builds the parameters, the AdamW state and the inputs as fake tensors
   (``FakeTensorMode``: shapes and dtypes, no storage), laid out as DTensor
   blocks by the binding rules, on a fake world of 256 (512) ranks
   (``launch.mesh.fake_world``), this process rank 0 of it;
2. runs one call of the port's sharded step once (the train step's, the
   prefill's or the serve step's ``.eager``; a decode cell's cache as fake
   DTensor blocks under ``launch.shardings.cache_shardings``), under
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
gives temp bytes.  Each record names the plan the sharded step takes over
``model`` (``model_split``, ``launch.shardings.model_split``): "compute"
splits the compute over it as the reference's tensor-parallel program
does, its model-axis all-reduces (and, where the head width is split,
all-to-alls) among the collectives, each axis's wire bytes by kind in
``collectives_by_axis``, and the rank it traced in ``traced_rank`` (rank
0, the first of its model group, which holds the most rows where the
attention's rows split raggedly); "gather" gathers
every split parameter into a whole buffer and runs each data rank's rows
on them, so a large model's peak can exceed 80 GB where the reference's
program fits: that is the finding, not a fault of the dry-run.  A
prefill or decode cell casts the floating parameters to
``cfg.serve_dtype`` where the config sets it, as the reference does, and
its record adds the cache's bytes per device, the port's
(``cache_bytes_per_device``: under the gather plan each rank holds its
rows' whole cache) and what the rules' shardings would store
(``cache_bytes_per_device_rules``, the reference's), and the bytes of the
one-time parameter gather (``gather_bytes_per_device``: the whole buffers
of the split parameters, 0 under the split plan) with its collectives
(``gather_collectives``), traced apart from the call's
(``step.prepare``): the peak counts both, the call's collectives and
FLOPs only the call's.

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
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig, supports_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch.op_inventory import OpInventory
from repro_torch.launch.roofline import HBM_BYTES
from repro_torch.launch.steps import make_prefill, make_serve_step, \
    make_train_step
from repro_torch.nn import module as module_lib
from repro_torch.optim import adamw

OUT_DIR = "experiments/dryrun_torch"
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


def _fake(a, device, dtype=None) -> torch.Tensor:
    return torch.zeros(a.shape, dtype=dtype or a.dtype, device=device)


def build_cell(arch: str, shape_name: str, mesh, *, cfg=None,
               shape: Optional[ShapeConfig] = None, device="cuda"):
    """(step, args, their shardings, the cell's config) of a cell: the
    fake tensors made in the caller's ``FakeTensorMode`` on ``device``, the
    parameters (and a train cell's state, a decode cell's cache) as
    DTensor blocks on ``mesh``.  A train cell's args are (params,
    opt_state, batch) and its config has the mesh-aware microbatches; a
    prefill cell's (params, batch), a decode cell's (params, cache,
    batch).  ``shape`` overrides the registry's shape (a tiny cell)."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or registry.get_shape(shape_name)
    rules = sh.rules_for(cfg)
    if shape.kind != "train":
        return _serve_cell(cfg, shape, mesh, device)
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
    input_sh = _input_shardings(cfg, shape, mesh)
    micro_sh = None
    if n_micro > 1:
        in_axes = registry.input_axes(cfg, shape)
        micro_sh = {
            k: sh.sharding_for(
                (n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]),
                (None,) + tuple(in_axes[k]), mesh, rules)
            for k, v in inputs.items()}

    whole = module_lib.map_tree(lambda a: _fake(a, device), abstract)
    params = sh.shard_tree(whole, param_sh)
    opt_state = sh.shard_tree(adamw.init_state(whole), opt_sh)
    batch = {k: _fake(v, device) for k, v in inputs.items()}
    step = make_train_step(cfg, microbatch_shardings=micro_sh,
                           grad_shardings=opt_sh["mu"])
    return step, (params, opt_state, batch), (param_sh, opt_sh, input_sh), \
        cfg


def _input_shardings(cfg, shape: ShapeConfig, mesh) -> dict:
    rules = sh.rules_for(cfg)
    inputs = registry.input_specs(cfg, shape)
    in_axes = registry.input_axes(cfg, shape)
    return {k: sh.sharding_for(tuple(v.shape), in_axes[k], mesh, rules)
            for k, v in inputs.items()}


def _serve_cell(cfg, shape: ShapeConfig, mesh, device):
    """:func:`build_cell` of a prefill or decode cell: the reference's
    ``build_cell`` other two kinds, the floating parameters in
    ``cfg.serve_dtype`` where it is set."""
    cfg = cfg.replace(microbatches=1)
    abstract, param_sh = sh.model_param_shardings(cfg, mesh)
    sd = getattr(torch, cfg.serve_dtype) if cfg.serve_dtype else None
    whole = module_lib.map_tree(lambda a: _fake(
        a, device, sd if a.dtype.is_floating_point else None), abstract)
    params = sh.shard_tree(whole, param_sh)
    batch = {k: _fake(v, device)
             for k, v in registry.input_specs(cfg, shape).items()}
    input_sh = _input_shardings(cfg, shape, mesh)
    if shape.kind == "prefill":
        return make_prefill(cfg), (params, batch), (param_sh, input_sh), cfg
    cache_abs, _ = sh.cache_abstract_and_axes(cfg, shape.global_batch,
                                              shape.seq_len)
    cache_sh = sh.cache_shardings(cfg, shape.global_batch, shape.seq_len,
                                  mesh)
    cache = sh.shard_tree(module_lib.map_tree(
        lambda a: _fake(a, device), cache_abs), cache_sh)
    return make_serve_step(cfg), (params, cache, batch), \
        (param_sh, cache_sh, input_sh), cfg


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
            split = sh.model_split(cell_cfg, mesh) is not None
            groups = {a: dist.get_process_group_ranks(mesh.group(a))
                      for a in axes if mesh.shape[a] > 1}
            traced = dict(zip(axes, mesh.coordinate()))
            params, state, batch = args[0], args[1:-1], args[-1]
            tracker = MemTracker()
            tracker.track_external(*(sh.local(t) for t in
                                      module_lib.tree_leaves(
                                          (params, state))),
                                   *batch.values())
            inventory, gathering = OpInventory(), OpInventory()
            flops = FlopCounterMode(display=False, custom_mapping={
                torch.ops.aten.bmm: _bmm_flops})
            with tracker:
                if shape.kind != "train":
                    with gathering:       # the serving plan's one gather
                        step.prepare(params)
                with flops, inventory:
                    out = step.eager(*args)
            peak = tracker.get_tracker_snapshot("peak")
            outputs = out[2].values() if shape.kind == "train" else [
                sh.local(out if shape.kind == "prefill" else out[0])]
            output_bytes = sum(t.numel() * t.element_size() for t in outputs)
        report = inventory.report()
        peak_bytes = max(v["Total"] for v in peak.values())
        if shape.kind == "decode":
            # what the rules' shardings of the cache store: the reference's
            cache_abs, cache_axes = sh.cache_abstract_and_axes(
                cell_cfg, shape.global_batch, shape.seq_len)
            rec.update({
                "cache_bytes_per_device": _local_bytes(state),
                "cache_bytes_per_device_rules": sh.bytes_per_device(
                    cache_abs, sh.tree_shardings(
                        cache_abs, cache_axes, mesh_lib.Mesh(
                            dict(zip(axes, sizes))), sh.rules_for(cell_cfg)))})
        elif shape.kind == "prefill":
            rec.update({"cache_bytes_per_device": 0,
                        "cache_bytes_per_device_rules": 0})
        if shape.kind != "train":
            gather = gathering.report()
            rec["gather_bytes_per_device"] = 0 if split else sum(
                math.prod(t.shape) * t.element_size()
                for t in module_lib.tree_leaves(params)
                if tuple(sh.local(t).shape) != tuple(t.shape))
            rec["gather_collectives"] = {
                "collective_bytes_per_device": gather.collective_bytes,
                "collectives_by_kind": gather.by_kind(),
                "collective_bytes_by_link": gather.by_link()}
        rec.update({
            "status": "ok",
            "model_split": "compute" if split else "gather",
            "trace_s": round(time.perf_counter() - t0, 2),
            "microbatches": cell_cfg.microbatches,
            "data_ways": mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
            if _batch_split(cell_cfg, shape, mesh) else 1,
            "memory": {
                "argument_bytes": _local_bytes((params, state))
                + sum(t.numel() * t.element_size() for t in batch.values()),
                "output_bytes": output_bytes,
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
            "collectives_by_axis": report.by_axis(groups),
            "collective_bytes_by_link": report.by_link(),
            "traced_rank": {"rank": 0, "coordinate": traced},
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
                          f"{rec['model_split']}, trace {rec['trace_s']}s, "
                          f"TF/dev {rec['flops_per_device'] / 1e12:.3f}, "
                          f"collMB/dev "
                          f"{rec['collective_bytes_per_device'] / 1e6:.1f}, "
                          f"peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB"
                          + (f", cache {rec['cache_bytes_per_device'] / 1e9:.2f}"
                             f" GB" if rec.get('cache_bytes_per_device')
                             else "")
                          + f"{'' if rec['fits'] else ' (does not fit)'}",
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
