"""The port's dry-run (``launch.dryrun``, ``launch.op_inventory``,
``launch.roofline``, ``launch.mesh.fake_world``), held against the
reference's ``repro.launch.dryrun`` on tiny cells.

Each fake world runs in a subprocess of its own (a process has one default
process group), all at once, beside the reference in one subprocess on 8
XLA host devices.  The cells are the tiny configs at batch 8 x 32 in one
microbatch, on fake CPU tensors: every kernel's wrapper takes its plain
version there.  Checks:

* the reference test's cell (tiny gemma2-27b in 2 microbatches on a
  2 x 2 x 2 (pod, data, model) world) traces with status "ok";
* ``params_bytes_per_device`` equals the reference's exactly, for tiny
  qwen2.5-3b and qwen2-moe-a2.7b on data 4 x model 1;
* ``flops_per_device`` within 10% of the reference's
  ``hlo.dot_flops_per_device`` (the sources of the gap:
  :func:`test_flops_per_device_hold_to_the_reference`);
* the collective kinds and wire bytes of a hand-counted case, and the link
  each crosses;
* the kernels' fake implementations (fake CUDA tensors, which a CPU
  build of torch makes though it cannot slice them) launch and count nothing,
  while the op inventory and ``FlopCounterMode`` see each op;
* the split plan (tensor parallelism over ``model``): tiny gemma2-27b,
  stablelm-3b, recurrentgemma-9b, qwen2-moe-a2.7b and qwen2.5-3b (its
  head width split) train cells on data 2 x model 4 record
  ``model_split`` "compute", their parameter bytes per device the
  reference's and their FLOPs within 10% of the reference's;
* item 8.8's cells: tiny prefill and decode cells on data 4 x model 1
  trace "ok", their parameter and cache bytes per device the reference's,
  their FLOPs the reference's (the MoE's as the reference's single-device
  count over 4, a decode step's plus its buffer's expert rows);
* the hill-climb over a tiny cell of ``rg_long``'s kind;
* the roofline's terms from a record, a train, a prefill and a decode
  one.

On the card (``gpu``): ``torch.library.opcheck`` on the three custom ops.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-3b", "qwen2-moe-a2.7b")
#: the configs whose compute splits over model (the split plan)
TP_ARCHS = ("gemma2-27b", "stablelm-3b", "recurrentgemma-9b",
            "qwen2-moe-a2.7b", "qwen2.5-3b")
BATCH, SEQ = 8, 32

PORT = r"""
import json, pathlib, sys
import torch
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

world, out_dir = sys.argv[1], pathlib.Path(sys.argv[2])
batch, seq = int(sys.argv[3]), int(sys.argv[4])
shape = ShapeConfig("tiny_train", seq, batch, "train")
res = {}
if world in ("4x1", "1x1"):
    data = int(world[0])
    for arch in ("qwen2.5-3b", "qwen2-moe-a2.7b"):
        res[arch] = dryrun.run_cell(
            arch, "tiny_train", {"data": data, "model": 1}, out_dir,
            cfg=registry.get_tiny(arch).replace(microbatches=1), shape=shape,
            device="cpu")
elif world == "serve":      # prefill and decode cells on data 4 x model 1
    for arch in ("qwen2.5-3b", "qwen2-moe-a2.7b"):
        for kind, s in (("prefill", seq), ("decode", 2 * seq)):
            res[f"{arch}/{kind}"] = dryrun.run_cell(
                arch, f"tiny_{kind}", {"data": 4, "model": 1}, out_dir,
                cfg=registry.get_tiny(arch),
                shape=ShapeConfig(f"tiny_{kind}", s, batch, kind),
                device="cpu")
elif world == "2x4":        # the split plan, on data 2 x model 4
    for arch in ("gemma2-27b", "stablelm-3b", "recurrentgemma-9b",
                 "qwen2-moe-a2.7b", "qwen2.5-3b"):
        res[arch] = dryrun.run_cell(
            arch, "tiny_train", {"data": 2, "model": 4}, out_dir,
            cfg=registry.get_tiny(arch).replace(microbatches=1), shape=shape,
            device="cpu")
elif world == "2x2x2":
    res["gemma2-27b"] = dryrun.run_cell(
        "gemma2-27b", "tiny_train", {"pod": 2, "data": 2, "model": 2},
        out_dir, cfg=registry.get_tiny("gemma2-27b").replace(microbatches=2),
        shape=shape, device="cpu")
else:       # the hand-counted collectives, on 2 x 2 and on 2 x 8
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.binding import NamedSharding, P
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.op_inventory import OpInventory
    for shp in ((2, 2), (2, 8)):
        with mesh_lib.fake_world(shp, ("data", "model"), "cpu") as mesh:
            flat = mesh_lib.make_test_mesh((shp[0] * shp[1], 1),
                                           ("data", "model"), "cpu")
            with FakeTensorMode(), OpInventory() as inv:
                x = torch.empty(4, 6)                   # 96 bytes
                mesh.reduce(x, ("data",))
                mesh.reduce(x, ("model",))
                mesh.gather_into(torch.empty(8, 16),    # (8, 16 / model)
                                 NamedSharding(mesh, P(None, "model")))
                flat.reduce(x, ("model",))              # one rank: nothing
            r = inv.report()
            res["x".join(map(str, shp))] = {
                "ops": [[c.kind, c.op, c.operand_bytes, c.result_bytes,
                         c.group_size, c.nodes, c.wire_bytes]
                        for c in r.collectives],
                "by_kind": r.by_kind(), "by_link": r.by_link(),
                "total": r.collective_bytes}
res["forbidden"] = sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "repro"))
(out_dir / f"port_{world}.json").write_text(json.dumps(res, default=str))
"""

REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import registry
from repro.launch import dryrun as dr, hlo_parse, shardings as sh
from repro.launch.steps import make_train_step

out_path, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
out = {}
for data, model, archs in ((4, 1, ("qwen2.5-3b", "qwen2-moe-a2.7b")),
                           (1, 1, ("qwen2.5-3b", "qwen2-moe-a2.7b")),
                           (2, 4, ("gemma2-27b", "stablelm-3b",
                                   "recurrentgemma-9b", "qwen2-moe-a2.7b",
                                   "qwen2.5-3b"))):
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         devices=jax.devices()[:data * model],
                         axis_types=(AxisType.Auto,) * 2)
    for arch in archs:
        cfg = registry.get_tiny(arch).replace(microbatches=1)
        with jax.set_mesh(mesh):
            _, args, in_sh, _, _ = dr.build_cell(arch, "train_4k", mesh,
                                                 cfg=cfg)
        inputs = {k: jax.ShapeDtypeStruct((batch, seq), jnp.int32)
                  for k in ("tokens", "targets")}
        rules = sh.rules_for(cfg)
        input_sh = {k: sh.sharding_for((batch, seq), ("batch", None), mesh,
                                       rules) for k in inputs}
        args = (args[0], args[1], inputs)
        step = make_train_step(cfg)
        with jax.set_mesh(mesh):
            out_abs = jax.eval_shape(step, *args)
            m_sh = jax.tree_util.tree_map(lambda _: sh.replicated(mesh),
                                          out_abs[2])
            compiled = jax.jit(
                step, in_shardings=(in_sh[0], in_sh[1], input_sh),
                out_shardings=(in_sh[0], in_sh[1], m_sh),
                donate_argnums=(0, 1)).lower(*args).compile()
        hlo = hlo_parse.analyze(compiled.as_text())
        out[f"{arch}/{data}x{model}"] = {
            "dot_flops_per_device": hlo.dot_flops,
            "params_bytes_per_device": sh.bytes_per_device(args[0],
                                                           in_sh[0])}
        if arch != "qwen2-moe-a2.7b":
            continue
        # the MoE layer's products in the step's first forward, each alone
        # (not the backward's recompute): the router, the experts' and the
        # shared expert's
        lines = compiled.as_text().splitlines()
        for name in ("nd,de->ne", "ecd,edf->ecf", "ecf,efd->ecd",
                     "nd,df->nf", "nf,fd->nd"):
            keep = [line for line in lines if " dot(" not in line or (
                'op_name="jit(train_step)/jvp()/' in line
                and f"/{name}/" in line)]
            out[f"{arch}/{data}x{model}"][f"forward/{name}"] = \
                hlo_parse.analyze("\n".join(keep)).dot_flops

# the prefill and decode cells on data 4 x model 1, as the reference's
# build_cell lays them out at the tiny shapes
from repro.configs.base import ShapeConfig
from repro.launch.steps import make_prefill, make_serve_step
for data, arch, kind, s in [
        (d, a, k, s) for d in (4, 1) for a in ("qwen2.5-3b", "qwen2-moe-a2.7b")
        for k, s in (("prefill", seq), ("decode", 2 * seq))]:
    mesh = jax.make_mesh((data, 1), ("data", "model"),
                         devices=jax.devices()[:data],
                         axis_types=(AxisType.Auto,) * 2)
    if True:
        cfg = registry.get_tiny(arch)
        shape = ShapeConfig(f"tiny_{kind}", s, batch, kind)
        rules = sh.rules_for(cfg)
        entry = sh.prune_spec((batch,), rules.spec(("batch",), mesh),
                              mesh)[0]
        if entry is not None:
            cfg = cfg.replace(batch_mesh_axes=(entry,))
        abstract, p_sh = sh.model_param_shardings(cfg, mesh)
        inputs = registry.input_specs(cfg, shape)
        in_axes = registry.input_axes(cfg, shape)
        input_sh = {k: sh.sharding_for(tuple(v.shape), in_axes[k], mesh,
                                       rules) for k, v in inputs.items()}
        rec = {"params_bytes_per_device": sh.bytes_per_device(abstract,
                                                              p_sh)}
        with jax.set_mesh(mesh):
            if kind == "prefill":
                out_sh = sh.sharding_for((batch, cfg.vocab_size),
                                         ("batch", "vocab"), mesh, rules)
                lowered = jax.jit(make_prefill(cfg),
                                  in_shardings=(p_sh, input_sh),
                                  out_shardings=out_sh).lower(abstract,
                                                              inputs)
            else:
                cache_abs, c_sh = dr._cache_abstract_and_shardings(
                    cfg, shape, mesh, rules)
                rec["cache_bytes_per_device"] = sh.bytes_per_device(
                    cache_abs, c_sh)
                tok_sh = sh.sharding_for((batch,), ("batch",), mesh, rules)
                lowered = jax.jit(make_serve_step(cfg),
                                  in_shardings=(p_sh, c_sh, input_sh),
                                  out_shardings=(tok_sh, c_sh),
                                  donate_argnums=(1,)).lower(
                                      abstract, cache_abs, inputs)
            text = lowered.compile().as_text()
        rec["dot_flops_per_device"] = hlo_parse.analyze(text).dot_flops
        out[f"{arch}/{kind}/{data}x1"] = rec
json.dump(out, open(out_path, "w"))
"""

WORLDS = ("4x1", "1x1", "2x4", "2x2x2", "collectives", "serve")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: the port's records}, the reference's numbers: every
    subprocess at once."""
    pytest.importorskip("jax")
    work = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {w: subprocess.Popen(
        [sys.executable, "-c", PORT, w, str(work), str(BATCH), str(SEQ)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for w in WORLDS}
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(work / "reference.json"),
         str(BATCH), str(SEQ)],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    port = {w: json.loads((work / f"port_{w}.json").read_text())
            for w in WORLDS}
    return port, json.loads((work / "reference.json").read_text())


def test_fake_worlds_import_neither_jax_nor_repro(runs):
    port, _ = runs
    for w in WORLDS:
        assert port[w]["forbidden"] == [], w


def test_reference_test_cell_traces_ok_on_2x2x2(runs):
    """Tiny gemma2-27b (local and global layers, post-norms, soft-caps) in
    2 microbatches on a (pod 2, data 2, model 2) world, the cell of the
    reference's ``test_small_mesh_dryrun_subprocess``."""
    rec = runs[0]["2x2x2"]["gemma2-27b"]
    assert rec["status"] == "ok", rec.get("traceback", "")[-3000:]
    assert rec["mesh"] == "2x2x2" and rec["microbatches"] == 2
    assert rec["data_ways"] == 4 and rec["fits"]
    assert rec["flops_per_device"] > 0 and rec["n_collective_ops"] > 0
    assert set(rec["collectives_by_kind"]) <= {"all-reduce", "all-gather"}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bytes_per_device_equal_the_reference(runs, arch):
    port, ref = runs
    for world in ("4x1", "1x1"):
        rec = port[world][arch]
        assert rec["status"] == "ok", rec.get("traceback", "")[-3000:]
        assert rec["params_bytes_per_device"] == \
            ref[f"{arch}/{world}"]["params_bytes_per_device"]


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_per_device_hold_to_the_reference(runs, arch):
    """Within 10% of the reference's HLO dot FLOPs per device.  The
    sources of the gap:

    * what is counted: ``FlopCounterMode`` counts aten matmuls (``mm``,
      ``bmm``: the projections, the MoE's expert products, the plain
      attention's scores and sums, and the backward's), the reference
      every HLO ``dot``; neither counts elementwise work;
    * attention: the port's plain attention forward and K5's backward
      recompute the full S x S scores of a causal layer, and the
      backward's key blocks hold min(512, S) keys, where the reference's
      blockwise VJP uses the config's ``attn_block_size``;
    * the MoE under data 4: the port routes each rank's rows and runs the
      expert products over its kept rows only (1/4 of the single-device
      work to 1%), where the reference's GSPMD program repeats part of
      them on every data rank (its count is 40% above a quarter of its own
      single-device count).  So the MoE is held to the reference's
      single-device count over 4, and to at most its data-4 count.

    On one device both models are held to the reference's count."""
    port, ref = runs
    for world in ("4x1", "1x1"):
        got = port[world][arch]["flops_per_device"]
        want = ref[f"{arch}/{world}"]["dot_flops_per_device"]
        if arch == "qwen2-moe-a2.7b" and world == "4x1":
            single = ref[f"{arch}/1x1"]["dot_flops_per_device"]
            assert got <= want and want > 1.3 * single / 4
            want = single / 4
        assert abs(got - want) <= 0.1 * want, (world, got, want)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_split_plan_cells_hold_to_the_reference(runs, arch):
    """Tiny gemma2-27b (its 2 KV heads whole on model 4, its 4 query heads
    split), stablelm-3b, recurrentgemma-9b (its one KV head whole, its
    RG-LRU channels and heads split), qwen2-moe-a2.7b (its 8 experts
    split 2 a rank) and qwen2.5-3b (its head width of 16 split 4 a rank)
    on data 2 x model 4 take the split plan: the parameter bytes per
    device the reference's exactly, the FLOPs per device within 10% of
    the reference's GSPMD program's (each rank computes its heads or
    head-width columns, MLP columns, RG-LRU channels, experts and
    vocabulary rows, and qwen2.5-3b's its 4 of the data rank's 16 (batch
    x head) rows, which divide the 4 ranks; under the gather plan every
    rank of a model group repeated the group's compute, about 4 x), and
    the model-axis all-reduces among the collectives, with qwen2.5-3b's
    all-to-alls (its q/k/v and output exchanges).  On data 4 x model 1
    and on 1 x 1 ``model`` keeps extent 1 and each config takes its
    production plan, the split plan (qwen2.5-3b's over ``head_dim``).

    The MoE's FLOPs as in :func:`test_flops_per_device_hold_to_the_reference`
    under data 4: the reference's GSPMD program repeats its MoE layers'
    first forward on both data ranks (its count is 17% above its
    single-device count over 8; ROADMAP.md R11,
    :func:`test_reference_repeats_the_moe_forward_on_both_data_ranks`),
    where the port runs each data rank's kept rows on each model rank's
    experts once; so it is held within 10% of the reference's
    single-device count over 8 (the router, whole on every rank, above
    it), and to at most its data 2 x model 4 count."""
    port, ref = runs
    rec = port["2x4"][arch]
    want = ref[f"{arch}/2x4"]
    assert rec["status"] == "ok", rec.get("traceback", "")[-3000:]
    assert rec["model_split"] == "compute" and rec["data_ways"] == 2
    assert rec["params_bytes_per_device"] == want["params_bytes_per_device"]
    got, flops = rec["flops_per_device"], want["dot_flops_per_device"]
    if arch == "qwen2-moe-a2.7b":
        single = ref[f"{arch}/1x1"]["dot_flops_per_device"]
        assert got <= flops and flops > 1.15 * single / 8, (got, flops)
        flops = single / 8
    assert abs(got - flops) <= 0.1 * flops, (got, flops)
    assert rec["collectives_by_kind"]["all-reduce"] > 0
    assert ("all-to-all" in rec["collectives_by_kind"]) == \
        (arch == "qwen2.5-3b")
    for world in ("4x1", "1x1"):
        for other in ARCHS:
            assert port[world][other]["model_split"] == (
                "compute" if other in TP_ARCHS else "gather")


def test_reference_repeats_the_moe_forward_on_both_data_ranks(runs):
    """ROADMAP.md R11: the reference's GSPMD train step for tiny
    qwen2-moe-a2.7b on data 2 x model 4 runs its MoE layer's first forward
    on the whole batch on both data ranks: each expert and shared-expert
    product (``src/repro/nn/moe.py:123-126``, ``:139-142``) counts 2/8 of
    its single-device FLOPs a device, the router (``:91``) all of them,
    where its backward's products count 1/8.  So
    :func:`test_split_plan_cells_hold_to_the_reference` holds the port's
    MoE, which runs each data rank's rows once, to the single-device count
    over 8."""
    _, ref = runs
    one, split = ref["qwen2-moe-a2.7b/1x1"], ref["qwen2-moe-a2.7b/2x4"]
    for name in ("ecd,edf->ecf", "ecf,efd->ecd", "nd,df->nf", "nf,fd->nd"):
        assert one[f"forward/{name}"] > 0, name
        assert split[f"forward/{name}"] == 2 * one[f"forward/{name}"] / 8, \
            name
    assert split["forward/nd,de->ne"] == one["forward/nd,de->ne"] > 0


def test_collectives_follow_the_cost_model(runs):
    """Hand-counted: an all-reduce of 96 bytes over data and over model
    (2 x 96 on the wire each), the all-gather of an (8, 16) fp32 tensor
    split over model (its result on the wire: 512 bytes, from parts of
    512 / model), and an all-reduce over a one-rank group, which moves
    nothing and is not recorded.  On
    2 x 2 every group lies in one node of 8 cards (NVLink); on 2 x 8 a
    data group {r, r + 8} spans two nodes (InfiniBand) and a model group
    of 8 one."""
    res = runs[0]["collectives"]
    for world in ("2x2", "2x8"):
        ops = res[world]["ops"]
        model = int(world[-1])
        assert [o[:4] for o in ops] == [
            ["all-reduce", "c10d::allreduce_", 96, 96],
            ["all-reduce", "c10d::allreduce_", 96, 96],
            ["all-gather", "c10d::allgather_", 512 // model, 512]]
        assert [o[6] for o in ops] == [192.0, 192.0, 512.0]
        assert res[world]["by_kind"] == {"all-reduce": 384.0,
                                         "all-gather": 512.0}
        assert res[world]["total"] == 896.0
    assert res["2x2"]["by_link"] == {"nvlink": 896.0, "infiniband": 0.0}
    assert [o[4:6] for o in res["2x8"]["ops"]] == [[2, 2], [8, 1], [8, 1]]
    assert res["2x8"]["by_link"] == {"nvlink": 704.0, "infiniband": 192.0}


def test_fake_kernels_launch_nothing_and_are_counted():
    """The three custom ops on fake CUDA tensors: their fake
    implementations run, every wrapper's ``launches`` stays as it was, the
    op inventory counts one launch each, and ``FlopCounterMode`` counts
    each by its formula (K5: 4·BH·S_q·S_kv·D; the sLSTM forward and
    backward: 8·B·S·H·W² each)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.slstm_scan.slstm_scan import (
        SAVES, slstm_scan, slstm_scan_backward)
    from repro_torch.launch.op_inventory import OpInventory

    before = (flash_attention.launches, slstm_scan.launches,
              slstm_scan_backward.launches, registry.launch_counts())
    b, h, s, d, nh, w = 2, 3, 16, 8, 2, 12
    with FakeTensorMode():
        q = torch.empty(b, h, s, d, device="cuda")
        xs = [torch.empty(1, 5, nh, w, device="cuda") for _ in range(4)]
        rec = [torch.empty(nh, w, w, device="cuda") for _ in range(4)]
        st = [torch.empty(1, nh, w, device="cuda") for _ in range(4)]
        with FlopCounterMode(display=False) as flops, OpInventory() as inv:
            out = flash_attention(q, q, q, lse=torch.empty(
                b * h, s, device="cuda"))
            hs = slstm_scan(xs, rec, *st,
                            saves=[torch.empty_like(xs[0]) for _ in SAVES])
            dx = slstm_scan_backward(hs, rec, [torch.empty_like(xs[0])
                                               for _ in SAVES], *st[1:])
    assert out.shape == q.shape and hs.shape == xs[0].shape and len(dx) == 4
    assert (flash_attention.launches, slstm_scan.launches,
            slstm_scan_backward.launches, registry.launch_counts()) == before
    assert inv.report().kernel_launches == {
        "flash_attention": 1, "slstm_scan": 1, "slstm_scan_backward": 1}
    counts = {str(k).split(".")[-1]: v
              for k, v in flops.get_flop_counts()["Global"].items()}
    assert counts == {"flash_attention": 4 * b * h * s * s * d,
                      "slstm_scan": 8 * 1 * 5 * nh * w * w,
                      "slstm_scan_backward": 8 * 1 * 5 * nh * w * w}


def test_prefill_and_decode_cells_report_item_8_8(runs):
    """Item 8.8's cells: tiny qwen2.5-3b's and qwen2-moe-a2.7b's prefill
    (8 x 32) and decode (8 lanes, a cache of 64) on data 4 x model 1
    trace "ok", their parameter bytes per device equal to the
    reference's, a decode cell's cache bytes equal to the reference's
    cache argument (on model 1 the port's cache shardings are the
    rules'), a prefill's zero; no process group is left behind."""
    import torch.distributed as dist
    port, ref = runs
    for arch in ARCHS:
        for kind in ("prefill", "decode"):
            rec = port["serve"][f"{arch}/{kind}"]
            want = ref[f"{arch}/{kind}/4x1"]
            assert rec["status"] == "ok", rec.get("traceback", "")[-3000:]
            assert rec["supported"] and rec["data_ways"] == 4 and rec["fits"]
            assert rec["params_bytes_per_device"] == \
                want["params_bytes_per_device"]
            assert rec["cache_bytes_per_device"] == \
                rec["cache_bytes_per_device_rules"] == \
                want.get("cache_bytes_per_device", 0)
            assert rec["gather_bytes_per_device"] == 0    # model 1
            assert rec["memory"]["output_bytes"] == (
                2 * cfg_vocab(arch) * 4 if kind == "prefill" else 2 * 4)
    assert not dist.is_initialized()


def cfg_vocab(arch) -> int:
    from repro_torch.configs import registry
    return registry.get_tiny(arch).vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_flops_hold_to_the_reference(runs, arch):
    """FLOPs per device of the prefill and decode cells on data 4 against
    the reference's HLO dot FLOPs.  The dense model's equal them.  The
    MoE's prefill equals the reference's single-device count over 4 (its
    GSPMD program repeats expert products on every data rank, as in
    :func:`test_flops_per_device_hold_to_the_reference`); its decode is
    that plus the expert rows each rank's buffer holds beyond a quarter
    of the whole batch's: ``min(C, lanes)`` rows per expert on each of 4
    ranks against C on one device (C = 3 at 8 lanes), three products of
    d x ffn per row; at most the reference's data-4 count."""
    from repro_torch.configs import registry
    port, ref = runs
    for kind in ("prefill", "decode"):
        got = port["serve"][f"{arch}/{kind}"]["flops_per_device"]
        want = ref[f"{arch}/{kind}/4x1"]["dot_flops_per_device"]
        single = ref[f"{arch}/{kind}/1x1"]["dot_flops_per_device"]
        if arch == "qwen2.5-3b":
            assert abs(got - want) <= 0.1 * want, (kind, got, want)
            continue
        assert got <= want, (kind, got, want)
        if kind == "prefill":
            assert got == single / 4, (got, single)
            continue
        cfg = registry.get_tiny(arch)
        cap = max(1, int(BATCH * cfg.experts_per_token / cfg.n_experts
                         * cfg.capacity_factor))
        rows = min(cap, BATCH // 4)
        extra = 3 * 2 * cfg.n_experts_padded * cfg.d_model * \
            cfg.expert_d_ff * cfg.n_layers * (rows - cap / 4)
        assert got == single / 4 + extra, (got, single / 4, extra)


def test_a_fake_world_refuses_a_live_group_and_a_missing_card():
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            with fake_world((2, 2), ("data", "model")):
                pass
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            with fake_world((2, 2), ("data", "model"), "cpu"):
                pass
    finally:
        dist.destroy_process_group()


def test_roofline_terms_of_a_record(tmp_path):
    """Each term of one record by hand: the FLOPs over the bf16 roof, the
    traffic model over HBM, each link's wire bytes over its rate."""
    from repro_torch.configs import registry
    from repro_torch.launch import roofline as rl
    rec = {"arch": "qwen2.5-3b", "shape": "train_4k", "status": "ok",
           "flops_per_device": 2e15, "params_bytes_per_device": 4e8,
           "params_whole_bytes": 1.2e10, "microbatches": 4, "data_ways": 16,
           "collective_bytes_by_link": {"nvlink": 9e9, "infiniband": 1e10},
           "memory": {"peak_bytes": 9e10}}
    (tmp_path / "qwen2.5-3b__train_4k__single.json").write_text(
        json.dumps(rec))
    (row,) = rl.load_cells(str(tmp_path))
    cfg = registry.get_config("qwen2.5-3b")
    traffic = 4 * (3e9 * (3 + 12 + 2) + 7 * 1e8) + \
        8 * cfg.n_layers * 256 * 4096 / 16 * cfg.d_model * 2
    assert row.compute_s == pytest.approx(2e15 / 989e12)
    assert row.memory_s == pytest.approx(traffic / 3.35e12)
    assert row.collective_s == pytest.approx(9e9 / 450e9 + 1e10 / 50e9)
    assert row.dominant == "compute" and not row.fits
    assert row.traced_flops == 2e15 * 256
    assert "| qwen2.5-3b | train_4k |" in rl.to_markdown([row])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_opcheck_flash_attention(card):
    q = torch.randn(2, 3, 64, 32, device=card)
    out = torch.empty_like(q)
    lse = torch.empty(6, 64, device=card)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q, q.clone(), q.clone(), out, lse, True, 0, 0.0))


@pytest.mark.gpu
def test_opcheck_slstm_scan(card):
    from repro_torch.kernels.slstm_scan.slstm_scan import SAVES
    b, s, nh, w = 2, 5, 2, 16
    xs = [torch.randn(b, s, nh, w, device=card) for _ in range(4)]
    rec = [torch.randn(nh, w, w, device=card) * 0.1 for _ in range(4)]
    st = [torch.zeros(b, nh, w, device=card) for _ in range(3)] + [
        torch.full((b, nh, w), -1e30, device=card)]
    torch.library.opcheck(
        torch.ops.repro_torch.slstm_scan.default,
        (xs, rec, *st, torch.empty_like(xs[0]),
         [torch.empty_like(xs[0]) for _ in SAVES]))


@pytest.mark.gpu
def test_opcheck_slstm_scan_backward(card):
    from repro_torch.kernels.slstm_scan.slstm_scan import SAVES, slstm_scan
    b, s, nh, w = 2, 5, 2, 16
    xs = [torch.randn(b, s, nh, w, device=card) for _ in range(4)]
    rec = [torch.randn(nh, w, w, device=card) * 0.1 for _ in range(4)]
    start = [torch.zeros(b, nh, w, device=card) for _ in range(3)] + [
        torch.full((b, nh, w), -1e30, device=card)]
    saves = [torch.empty_like(xs[0]) for _ in SAVES]
    slstm_scan(xs, rec, *[t.clone() for t in start], saves=saves)
    torch.library.opcheck(
        torch.ops.repro_torch.slstm_scan_backward.default,
        (torch.randn(b, s, nh, w, device=card), rec, saves, *start[1:],
         [torch.empty_like(xs[0]) for _ in range(4)]))


def test_hillclimb_summarizes_variants_and_the_decode_skip(tmp_path,
                                                           capsys):
    """The hill-climb's three cells carry the reference's variants; its
    summary reads a baseline and a variant's records, and traces and
    summarises a decode cell of ``rg_long``'s kind: tiny
    recurrentgemma-9b at batch 1 (no data axis divides it: each rank
    serves the whole batch), its ``bf16serve`` variant's parameters half
    the baseline's bytes."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hillclimb
    names = {k: [t for t, _ in f()[2]] for k, f in hillclimb.CELLS.items()}
    assert names["moe_train"][:3] == ["bf16reduce", "cap10", "chunk8"]
    assert names["rg_long"] == ["bf16serve", "bf16serve_q54"]
    assert len(names["stablelm_train"]) == 8
    rec = {"arch": "qwen2-moe-a2.7b", "shape": "train_4k", "status": "ok",
           "supported": True, "flops_per_device": 9.89e14,
           "collective_bytes_by_link": {"infiniband": 5e10},
           "memory": {"peak_bytes": 1.2e11}}
    for tag in ("", "cap10"):
        (tmp_path / f"qwen2-moe-a2.7b__train_4k__single"
                    f"{'__' + tag if tag else ''}.json").write_text(
            json.dumps(dict(rec, tag=tag)))
    hillclimb.summarize(tmp_path, "qwen2-moe-a2.7b", "train_4k")
    base = registry.get_tiny("recurrentgemma-9b")
    shape = ShapeConfig("tiny_long", 64, 1, "decode")
    recs = {tag: dryrun.run_cell(
        "recurrentgemma-9b", "tiny_long", {"data": 4, "model": 1}, tmp_path,
        cfg=cfg, tag=tag, shape=shape, device="cpu")
        for tag, cfg in (("", base),
                         ("bf16serve", base.replace(serve_dtype="bfloat16")))}
    hillclimb.summarize(tmp_path, "recurrentgemma-9b", "tiny_long",
                        mesh="4x1")
    out = capsys.readouterr().out
    assert "baseline                     1.0000     1.0000   120.00" in out
    assert "cap10                        1.0000     1.0000   120.00" in out
    for r in recs.values():
        assert r["status"] == "ok", r.get("traceback", "")[-3000:]
        assert r["data_ways"] == 1 and r["cache_bytes_per_device"] > 0
    assert 2 * recs["bf16serve"]["params_bytes_per_device"] == \
        recs[""]["params_bytes_per_device"]
    assert "== recurrentgemma-9b x tiny_long ==" in out
    for tag in ("baseline", "bf16serve"):
        assert any(line.startswith(f"{tag} ") and "FAILED" not in line
                   for line in out.splitlines()), tag


def test_roofline_serving_terms(tmp_path):
    """The memory term of a prefill and a decode record, by hand: the
    whole parameters read once; a prefill's 4 bf16 passes over each
    layer's tokens on this data rank, a decode step's cache and its
    lanes' slots; and the serving table's row of a record."""
    from repro_torch.configs import registry
    from repro_torch.launch import roofline as rl
    cfg = registry.get_config("qwen2.5-3b")
    pre = {"params_whole_bytes": 1.2e10, "data_ways": 16}
    assert rl.memory_bytes_cell("qwen2.5-3b", "prefill_32k", pre) == \
        pytest.approx(1.2e10 + 4 * cfg.n_layers * 32 * 32768 / 16
                      * cfg.d_model * 2)
    dec = {"params_whole_bytes": 1.2e10, "data_ways": 16,
           "cache_bytes_per_device": 9.7e9}
    assert rl.memory_bytes_cell("qwen2.5-3b", "decode_32k", dec) == \
        pytest.approx(1.2e10 + 9.7e9 + 2 * 128 / 16 * cfg.d_model * 2)
    assert rl.model_flops_cell("qwen2.5-3b", "decode_32k") == \
        pytest.approx(rl.model_flops_cell("qwen2.5-3b", "train_4k")
                      / 3 / (256 * 4096) * 128)
    rec = dict(dec, arch="qwen2.5-3b", shape="decode_32k", status="ok",
               tag="", fits=True, flops_per_device=1.3e11,
               cache_bytes_per_device_rules=6e8,
               gather_bytes_per_device=1.23e10, trace_s=5.1,
               kernel_launches={}, memory={"peak_bytes": 3.06e10})
    (tmp_path / "qwen2.5-3b__decode_32k__single.json").write_text(
        json.dumps(rec))
    assert rl.serving_table(str(tmp_path)).splitlines()[2] == (
        "| qwen2.5-3b | decode_32k | - | 30.60 | yes | 0.13 | 9.70 (0.60) "
        "| 12.30 | - | 5.1 |")
