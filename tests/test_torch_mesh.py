"""The port's sharded pieces on a real mesh of processes, held against the
reference on as many XLA host devices.

One ``torch.multiprocessing`` spawn of 4 gloo processes runs a 2 x 2
(data, model) mesh on the CPU; the reference runs in one subprocess with 8
host devices (``--xla_force_host_platform_device_count=8``), 4 of them in
a 2 x 2 mesh.  Both get the same numpy inputs, written by this process.
Checks:

* (a) the block of a tensor each mesh coordinate holds equals the
  reference's ``devices_indices_map`` for the device at that coordinate,
  on 2 x 2, 4 x 1 and 2 x 2 x 2 meshes (a ``("pod", "data")`` entry
  among them; the blocks are a function of the coordinate, so the 8-device
  mesh needs no 8 processes), and each rank's DTensor from
  ``distribute_tensor`` holds exactly that block;
* (b) ``compressed_psum`` over ``data`` equals the reference's under
  ``jax.shard_map`` bit for bit, the two data ranks' inputs at scales
  100x apart (the max-scale bound bites);
* (c) the sharded train step on tiny Qwen2.5-3B (fp32 activations; the
  split plan over its head width), batch 8 in 2 microbatches, the two
  data ranks holding different numbers of counted targets, equals the
  reference's ``make_train_step`` jitted with the same shardings:
  metrics, parameters and both moments (and the error feedback) within
  rtol 1e-5 / atol 1e-6 after 2 steps, with and without
  ``grad_compression``;
* (d) ``reshard_checkpoint`` of that run's checkpoint onto a 4 x 1 mesh
  (in the spawn) and onto a 1 x 1 CPU mesh (here) equals the saved leaves
  bit for bit;
* (e) the MoE tiny config under data = 2: its sharded step against the
  reference's at the bar of (c), tiny mixtral-8x7b's alike (it takes the
  gather plan: every rank gathers its split parameters whole), and one
  MoE layer whose token chunks
  overflow across the two data ranks' boundary, each rank routing its
  rows: the assignments it keeps (read off the outputs of probe weights,
  see :func:`_probe_layer`) exactly the reference's on the whole
  microbatch, its outputs and aux loss at the bar of (c);
* (f) ``bf16_reduce`` against the reference at the LM tests' bf16 bar.

On the card (``gpu``): the sharded step on a 1 x 1 NCCL mesh, replayed
from its captured graph, against the unsharded step, value for value;
``reshard_checkpoint`` onto that mesh, bit for bit.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.nn import module, transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
BF16_SCALE_TOL = 0.02                 # tests/test_torch_lm.py's bf16 bar
ARCH, MOE_ARCH = "qwen2.5-3b", "qwen2-moe-a2.7b"
#: a config that takes the gather plan on 2 x 2 (its experts' weights split
#: over ``data`` by ``expert_embed``, their hidden over ``model``)
GATHER_ARCH = "mixtral-8x7b"
BATCH, SEQ, MICRO, STEPS = 8, 24, 2, 2
#: the overflow layer: 96 tokens in 3 chunks of 32, so the middle chunk
#: straddles the data ranks' boundary at token 48; capacity 5 of its ~10.7
#: assignments per expert
OVERFLOW = dict(n_experts=6, top_k=2, capacity_factor=0.5, token_chunks=3)
OPT = dict(peak_lr=1e-3, warmup_steps=2)
#: (mesh, tensor shape, spec) whose blocks are held to the reference's
BLOCK_CASES = [
    ("2x2", (8, 6), [["data", "model"], None]),
    ("2x2", (8, 6), ["data", "model"]),
    ("2x2", (4, 6, 2), [None, "model", "data"]),
    ("2x2", (8,), [None]),
    ("4x1", (8, 6), ["data", "model"]),
    ("4x1", (4, 8), [None, "data"]),
    ("2x2x2", (8, 6), [["pod", "data"], "model"]),
    ("2x2x2", (4, 8, 2), ["model", ["pod", "data"], None]),
    ("2x2x2", (8, 4), [["pod", "data", "model"], None]),
]
MESH_SHAPES = {"2x2": ((2, 2), ("data", "model")),
               "4x1": ((4, 1), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _spec(entries):
    from repro_torch.core.binding import P
    return P(*(tuple(e) if isinstance(e, list) else e for e in entries))


# ---------------------------------------------------------------------------
# the inputs both sides read
# ---------------------------------------------------------------------------

def _weights(cfg, seed):
    """The reference's ``init_tree`` rule, drawn with numpy, as {path:
    array} in the trees' order."""
    rng = np.random.default_rng(seed)
    out = {}

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale if spec.scale is not None else spec.fan_in() ** -0.5
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    for path, a in _flat(module.map_specs(draw, transformer.model_specs(
            cfg))).items():
        out[path] = a
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat: dict, cfg) -> dict:
    """``flat``'s arrays in the structure of ``cfg``'s parameter tree
    (its empty subtrees too)."""
    def fill(t, prefix):
        if isinstance(t, dict):
            return {k: fill(t[k], f"{prefix}{k}/") for k in t}
        return flat[prefix[:-1]]
    return fill(transformer.model_specs(cfg), "")


def _batches(cfg, seed):
    """Two batches of 8 x 24 whose data ranks hold unequal counts of
    targets: in each microbatch (4 rows; rows 0-1 on data rank 0, 2-3 on
    rank 1) rank 1's rows lose 15 of 24 targets, rank 0's 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        tgt = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        tgt[:, -1] = -1
        for mb in range(MICRO):
            tgt[mb * 4 + 2:mb * 4 + 4, :15] = -1
        out.append({"tokens": toks, "targets": tgt})
    return out


def _inputs(path: pathlib.Path) -> dict:
    cfg = registry.get_tiny(ARCH)
    arrays = {f"w/{k}": v for k, v in _weights(cfg, 0).items()}
    moe = registry.get_tiny(MOE_ARCH)
    arrays.update({f"moe/{k}": v for k, v in _weights(moe, 1).items()})
    arrays.update({f"gather/{k}": v for k, v in _weights(
        registry.get_tiny(GATHER_ARCH), 2).items()})
    for i, b in enumerate(_batches(cfg, 2)):
        for k, v in b.items():
            arrays[f"b{i}/{k}"] = v
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    x[2:] *= 100.0                   # data rank 1's scale 100x rank 0's
    arrays["psum_x"] = x
    probe, px = _probe_layer(moe, 4)
    arrays.update({f"probe/{k}": v for k, v in _flat(probe).items()})
    arrays["probe_x"] = px
    np.savez(path, **arrays)
    return arrays


def _probe_layer(cfg, seed):
    """An MoE layer of ``cfg``'s widths whose outputs name the kept
    assignments, and its input (4, 24, d): each token's feature 0 is 1, every
    expert maps it to ``silu(1)`` times its own unit vector e (``wi``, ``wg``
    read feature 0 only, ``wo`` writes feature e only), the shared experts
    are zero, the router is drawn.  So ``y[token, e]`` is its gate times
    silu(1) where its assignment to expert e is kept and exactly 0
    where it is dropped or absent."""
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.n_experts_padded, cfg.expert_d_ff
    wi = np.zeros((e, d, ff), np.float32)
    wi[:, 0, :] = 1.0
    wo = np.zeros((e, ff, d), np.float32)
    for i in range(e):
        wo[i, :, i] = 1.0 / ff
    sf = cfg.shared_d_ff
    p = {"router": {"kernel": rng.standard_normal((d, e)).astype(np.float32)},
         "experts": {"wi": wi, "wg": wi.copy(), "wo": wo},
         "shared": {"wi": np.zeros((d, sf), np.float32),
                    "wg": np.zeros((d, sf), np.float32),
                    "wo": np.zeros((sf, d), np.float32),
                    "gate": np.zeros((d, 1), np.float32)}}
    x = rng.standard_normal((4, SEQ, d)).astype(np.float32)
    x[..., 0] = 1.0
    return p, x


def _group(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 8 host devices
# ---------------------------------------------------------------------------

REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.launch import shardings as sh, steps
from repro.nn import module, transformer
from repro.optim import adamw, compress

inp, out_path, cases_json, meta = sys.argv[1:5]
arrays = dict(np.load(inp))
meta = json.loads(meta)
devs = jax.devices()
assert len(devs) == 8, devs


def mesh(shape, axes):
    n = int(np.prod(shape))
    return jax.make_mesh(tuple(shape), tuple(axes), devices=devs[:n],
                         axis_types=(AxisType.Auto,) * len(axes))


def spec(entries):
    return P(*(tuple(e) if isinstance(e, list) else e for e in entries))


out = {}
# (a) blocks per mesh coordinate
blocks = []
for mname, shape, entries in json.loads(cases_json):
    m = mesh(*meta["meshes"][mname])
    idx = NamedSharding(m, spec(entries)).devices_indices_map(tuple(shape))
    per = {}
    for c in np.ndindex(m.devices.shape):
        sl = idx[m.devices[c]]
        per[",".join(map(str, c))] = [
            [s.start or 0, n if s.stop is None else s.stop]
            for s, n in zip(sl, shape)]
    blocks.append(per)
out["blocks"] = np.frombuffer(json.dumps(blocks).encode(), np.uint8)

m22 = mesh((2, 2), ("data", "model"))
# (b) compressed_psum over data under shard_map
f = jax.shard_map(compress.compressed_psum("data"), mesh=m22,
                  in_specs=P("data", None), out_specs=P("data", None))
out["psum"] = np.asarray(jax.jit(f)(jnp.asarray(arrays["psum_x"])))


def nest(prefix, cfg):
    def fill(t, path):
        if isinstance(t, dict):
            return {k: fill(t[k], path + k + "/") for k in t}
        return jnp.asarray(arrays[prefix + "/" + path[:-1]])
    return fill(transformer.model_specs(cfg), "")


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k in sorted(tree):
            o.update(flat(tree[k], prefix + k + "/"))
        return o
    return {prefix[:-1]: np.asarray(tree)}


# (c) the sharded step
cfg = registry.get_tiny(meta["arch"]).replace(
    activation_dtype="float32", microbatches=meta["micro"])
rules = sh.rules_for(cfg)
abstract, p_sh = sh.model_param_shardings(cfg, m22)
axes = module.axes_tree(transformer.model_specs(cfg))
o_sh = sh.tree_shardings(adamw.abstract_state(abstract),
                         adamw.state_axes(axes), m22, rules)
b, s = meta["batch"], meta["seq"]
in_sh = {k: sh.sharding_for((b, s), ("batch", None), m22, rules)
         for k in ("tokens", "targets")}
micro_sh = {k: sh.sharding_for((meta["micro"], b // meta["micro"], s),
                               (None, "batch", None), m22, rules)
            for k in ("tokens", "targets")}
for comp in (False, True):
    params = jax.device_put(nest("w", cfg), p_sh)
    state = adamw.init_state(params)
    st_sh = dict(o_sh)
    if comp:
        state["err"] = compress.init_error_state(params)
        st_sh["err"] = o_sh["mu"]
    state = jax.device_put(state, st_sh)
    step = jax.jit(steps.make_train_step(
        cfg, adamw.AdamWConfig(**meta["opt"]), grad_compression=comp,
        microbatch_shardings=micro_sh, grad_shardings=o_sh["mu"]),
        in_shardings=(p_sh, st_sh, in_sh),
        out_shardings=(p_sh, st_sh, sh.replicated(m22)))
    tag = "comp" if comp else "plain"
    for i in range(meta["steps"]):
        batch = {k: jnp.asarray(arrays[f"b{i}/{k}"])
                 for k in ("tokens", "targets")}
        params, state, m = step(params, state, batch)
        for k, v in m.items():
            out[f"{tag}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(state["mu"]).items():
            out[f"{tag}/mu{i}/{k}"] = v
    for name, tree in (("params", params), ("mu", state["mu"]),
                       ("nu", state["nu"])) + (
                           (("err", state["err"]),) if comp else ()):
        for k, v in flat(tree).items():
            out[f"{tag}/{name}/{k}"] = v
    out[f"{tag}/step"] = np.asarray(state["step"])

# (e) the MoE step under data = 2, the gather plan's config alike, and the
# overflow layer on the whole batch
for tag, arch in (("moe", meta["moe_arch"]), ("gather", meta["gather_arch"])):
    mcfg = registry.get_tiny(arch).replace(
        activation_dtype="float32", microbatches=meta["micro"])
    mab, mp_sh = sh.model_param_shardings(mcfg, m22)
    mo_sh = sh.tree_shardings(adamw.abstract_state(mab), adamw.state_axes(
        module.axes_tree(transformer.model_specs(mcfg))), m22,
        sh.rules_for(mcfg))
    params = jax.device_put(nest(tag, mcfg), mp_sh)
    state = jax.device_put(adamw.init_state(params), mo_sh)
    step = jax.jit(steps.make_train_step(
        mcfg, adamw.AdamWConfig(**meta["opt"]), microbatch_shardings=micro_sh,
        grad_shardings=mo_sh["mu"]), in_shardings=(mp_sh, mo_sh, in_sh),
        out_shardings=(mp_sh, mo_sh, sh.replicated(m22)))
    for i in range(meta["steps"]):
        batch = {k: jnp.asarray(arrays[f"b{i}/{k}"])
                 for k in ("tokens", "targets")}
        params, state, m = step(params, state, batch)
        for k, v in m.items():
            out[f"{tag}/m{i}/{k}"] = np.asarray(v)
        for k, v in flat(state["mu"]).items():
            out[f"{tag}/mu{i}/{k}"] = v
    for name, tree in (("params", params), ("mu", state["mu"]),
                       ("nu", state["nu"])):
        for k, v in flat(tree).items():
            out[f"{tag}/{name}/{k}"] = v
    out[f"{tag}/step"] = np.asarray(state["step"])
from repro.nn import moe as ref_moe
probe = {}
for k, v in arrays.items():
    if k.startswith("probe/"):
        node = probe
        *path, leaf = k[len("probe/"):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
y, aux = ref_moe.moe(probe, jnp.asarray(arrays["probe_x"]), **meta["overflow"])
out["overflow/y"], out["overflow/aux"] = np.asarray(y), np.asarray(aux)
np.savez(out_path, **out)
print("REFERENCE DONE")
"""


def _reference(inputs: pathlib.Path, out: pathlib.Path) -> subprocess.Popen:
    meta = {"meshes": MESH_SHAPES, "arch": ARCH, "moe_arch": MOE_ARCH,
            "gather_arch": GATHER_ARCH,
            "micro": MICRO, "batch": BATCH, "seq": SEQ, "opt": OPT,
            "steps": STEPS, "overflow": OVERFLOW}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(out),
         json.dumps(BLOCK_CASES), json.dumps(meta)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# the port, in 4 spawned gloo processes
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, port: int, inputs: str, out_dir: str):
    """One rank of the 2 x 2 mesh: every check's port side; its results
    into ``out_dir/rank<r>.npz`` (whole tensors from rank 0)."""
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = _rank_checks(rank, np.load(inputs), pathlib.Path(out_dir))
    finally:
        dist.destroy_process_group()
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)


def _rank_checks(rank, arrays, out_dir: pathlib.Path) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.binding import NamedSharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime.elastic import reshard_checkpoint

    res: dict = {}
    mesh = mesh_lib.make_test_mesh((2, 2), ("data", "model"), "cpu")
    coord = mesh.coordinate()
    res["coord"] = np.array(coord)

    # (a) DTensor's local block is the block the coordinate names
    agree = []
    for mname, shape, entries in BLOCK_CASES:
        if mname != "2x2":
            continue
        x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
            shape)
        s = NamedSharding(mesh, _spec(entries))
        d = distribute_tensor(x, mesh.device_mesh, s.placements,
                              src_data_rank=None)
        agree.append(torch.equal(d.to_local(), x[mesh.block(s, shape)]))
    res["dtensor_blocks_agree"] = np.array(agree)

    # (b) compressed_psum over data, on this rank's rows
    x = torch.from_numpy(arrays["psum_x"])
    rows = slice(2 * coord[0], 2 * coord[0] + 2)
    res["psum"] = compress.compressed_psum("data", mesh)(
        x[rows].clone()).numpy()

    # (c) the sharded step, with and without compression
    cfg = registry.get_tiny(ARCH).replace(activation_dtype="float32",
                                          microbatches=MICRO)
    rules = sh.rules_for(cfg)
    abstract, p_sh = sh.model_param_shardings(cfg, mesh)
    axes = module.axes_tree(transformer.model_specs(cfg))
    o_sh = sh.state_shardings(abstract, axes, mesh, rules)
    micro_sh = {k: sh.sharding_for((MICRO, BATCH // MICRO, SEQ),
                                   (None, "batch", None), mesh, rules)
                for k in ("tokens", "targets")}
    w = module.params_from_numpy(_nest(_group(arrays, "w"), cfg))
    batches = [{k: arrays[f"b{i}/{k}"] for k in ("tokens", "targets")}
               for i in range(STEPS)]
    ckpt_dir = out_dir / "ckpt"
    for comp in (False, True):
        params = sh.shard_tree(module.map_tree(torch.clone, w), p_sh)
        state = sh.shard_tree(adamw.init_state(w), o_sh)
        if comp:
            state["err"] = sh.shard_tree(compress.init_error_state(w),
                                         o_sh["mu"])
        step = steps.make_train_step(
            cfg, adamw.AdamWConfig(**OPT), grad_compression=comp,
            microbatch_shardings=micro_sh, grad_shardings=o_sh["mu"])
        tag = "comp" if comp else "plain"
        for i, b in enumerate(batches):
            params, state, m = step(params, state, b)
            for k, v in m.items():
                res[f"{tag}/m{i}/{k}"] = v.numpy()
            mu = module.map_tree(lambda t: t.full_tensor(), state["mu"])
            if rank == 0:
                for k, v in _flat(mu).items():
                    res[f"{tag}/mu{i}/{k}"] = v.numpy()
        whole = {"params": module.map_tree(lambda t: t.full_tensor(),
                                           params),
                 "opt": module.map_tree(lambda t: t.full_tensor(), state)}
        if rank == 0:
            for name, tree in (("params", whole["params"]),) + tuple(
                    (k, whole["opt"][k]) for k in ("mu", "nu", "err")
                    if k in whole["opt"]):
                for k, v in _flat(tree).items():
                    res[f"{tag}/{name}/{k}"] = v.numpy()
            res[f"{tag}/step"] = whole["opt"]["step"].numpy()
        if not comp and rank == 0:
            CheckpointManager(str(ckpt_dir)).save(2, {
                "params": whole["params"],
                "opt": {k: whole["opt"][k] for k in ("mu", "nu", "step")}})
    dist.barrier()

    # (d) the checkpoint onto a 4 x 1 mesh of the same processes
    mesh41 = mesh_lib.make_test_mesh((4, 1), ("data", "model"), "cpu")
    tree, got_step = reshard_checkpoint(CheckpointManager(str(ckpt_dir)),
                                        cfg, mesh41)
    saved = _saved_leaves(ckpt_dir / "step_000000002")
    differing = 0
    for (path, t), want in zip(_flat(tree).items(), saved):
        s41 = sh.sharding_of(t, mesh41)
        block = want[mesh41.block(s41, want.shape)]
        differing += int(not np.array_equal(t.to_local().numpy(), block))
    res["reshard41_differing"] = np.array(differing)
    res["reshard41_step"] = np.array(got_step)
    res["reshard41_leaves"] = np.array(len(saved))

    # (e) MoE under data = 2: the sharded step; the gather plan's config
    # alike; then the overflow layer
    res["moe_error"] = np.array("")
    try:
        res.update(_moe_steps("moe", MOE_ARCH, mesh, arrays, batches, rank))
    except NotImplementedError as e:
        res["moe_error"] = np.array(str(e))
    res.update(_moe_steps("gather", GATHER_ARCH, mesh, arrays, batches,
                          rank))
    res.update(_overflow_layer(mesh, arrays))
    return res


def _moe_steps(tag: str, arch: str, mesh, arrays, batches, rank) -> dict:
    """The sharded step of ``arch``'s tiny MoE config, its weights the
    inputs' ``tag/``, on ``batches``: each step's metrics and first moments,
    then (rank 0) the whole parameters and both moments."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    res = {}
    moe = registry.get_tiny(arch).replace(activation_dtype="float32",
                                          microbatches=MICRO)
    mrules = sh.rules_for(moe)
    mab, m_sh = sh.model_param_shardings(moe, mesh)
    mo_sh = sh.state_shardings(
        mab, module.axes_tree(transformer.model_specs(moe)), mesh, mrules)
    mmicro = {k: sh.sharding_for((MICRO, BATCH // MICRO, SEQ),
                                 (None, "batch", None), mesh, mrules)
              for k in ("tokens", "targets")}
    mw = module.params_from_numpy(_nest(_group(arrays, tag), moe))
    mparams = sh.shard_tree(mw, m_sh)
    mstate = sh.shard_tree(adamw.init_state(mw), mo_sh)
    step = steps.make_train_step(
        moe, adamw.AdamWConfig(**OPT), microbatch_shardings=mmicro,
        grad_shardings=mo_sh["mu"])
    for i, b in enumerate(batches):
        mparams, mstate, m = step(mparams, mstate, b)
        for k, v in m.items():
            res[f"{tag}/m{i}/{k}"] = v.numpy()
        mu = module.map_tree(lambda t: t.full_tensor(), mstate["mu"])
        if rank == 0:
            for k, v in _flat(mu).items():
                res[f"{tag}/mu{i}/{k}"] = v.numpy()
    whole = {"params": mparams, "mu": mstate["mu"], "nu": mstate["nu"]}
    whole = {k: module.map_tree(lambda t: t.full_tensor(), v)
             for k, v in whole.items()}
    if rank == 0:
        for name, tree in whole.items():
            for k, v in _flat(tree).items():
                res[f"{tag}/{name}/{k}"] = v.numpy()
        res[f"{tag}/step"] = mstate["step"].full_tensor().numpy()
    return res


def _overflow_layer(mesh, arrays) -> dict:
    """This rank's rows of the probe layer's input through ``moe`` as its
    data rank's block of the microbatch."""
    from repro_torch.nn import moe as moe_lib
    probe = module.params_from_numpy(_nest_flat(_group(arrays, "probe")))
    x = torch.from_numpy(arrays["probe_x"])
    index, ways = mesh.coordinate()[0], mesh.shape["data"]
    rows = x.shape[0] // ways
    shard = moe_lib.BatchShard(
        index=index, ways=ways, reduce=lambda t: mesh.reduce(t, ("data",)))
    with moe_lib.batch_shard(shard):
        y, aux = moe_lib.moe(probe, x[index * rows:(index + 1) * rows],
                             **OVERFLOW)
    return {"overflow/y": y.numpy(), "overflow/aux": aux.numpy()}


def _nest_flat(flat: dict) -> dict:
    """{"a/b": v} as {"a": {"b": v}}."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _saved_leaves(path: pathlib.Path) -> list:
    n = json.loads((path / "manifest.json").read_text())["n_leaves"]
    return [np.load(path / f"leaf_{i:05d}.npy") for i in range(n)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, each rank's results, the work dir): the
    reference's subprocess and the 4-rank spawn run at once."""
    pytest.importorskip("jax")
    import torch.multiprocessing as mp
    work = tmp_path_factory.mktemp("mesh")
    inputs = work / "inputs.npz"
    _inputs(inputs)
    proc = _reference(inputs, work / "reference.npz")
    try:
        mp.start_processes(_worker, args=(4, _free_port(), str(inputs),
                                          str(work)),
                           nprocs=4, start_method="spawn")
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    ref = dict(np.load(work / "reference.npz"))
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]
    return types.SimpleNamespace(ref=ref, ranks=ranks, work=work)


# ---------------------------------------------------------------------------
# (a)-(e)
# ---------------------------------------------------------------------------

def test_ranks_are_laid_out_row_major(runs):
    assert [tuple(r["coord"]) for r in runs.ranks] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_blocks_match_devices_indices_map(runs, case):
    from repro_torch.core.binding import NamedSharding
    from repro_torch.launch.mesh import Mesh
    want = json.loads(runs.ref["blocks"].tobytes().decode())[case]
    mname, shape, entries = BLOCK_CASES[case]
    dims, axes = MESH_SHAPES[mname]
    s = NamedSharding(Mesh(dict(zip(axes, dims))), _spec(entries))
    for c in np.ndindex(*dims):
        got = [[b.start, b.stop] for b in s.block(shape, c)]
        assert got == want[",".join(map(str, c))], (c, got)


def test_dtensor_holds_the_block_on_every_rank(runs):
    for r in runs.ranks:
        assert r["dtensor_blocks_agree"].all()


def test_compressed_psum_is_the_reference_bit_for_bit(runs):
    want = runs.ref["psum"]
    x = np.load(runs.work / "inputs.npz")["psum_x"]
    for r in runs.ranks:
        d = int(r["coord"][0])
        np.testing.assert_array_equal(r["psum"], want[2 * d:2 * d + 2])
    # the max-scale bound: data rank 0's integers count at rank 1's scale
    assert not np.allclose(want[:2], x[:2] + x[2:], rtol=1e-2)


def _bar(got, want):
    """Elements outside rtol 1e-5 / atol 1e-6."""
    return np.abs(got - want) > ATOL + RTOL * np.abs(want)


@pytest.mark.parametrize("tag", ["plain", "comp", "moe", "gather"])
def test_sharded_step_matches_reference(runs, tag):
    """Metrics after each step, and the state after two, against the
    reference's at rtol 1e-5 / atol 1e-6, every element but two kinds,
    each bounded by what it can do:

    * a parameter whose gradient at some step lay within 1,000 x AdamW's
      eps (1e-8) of zero: its update there, g / (|g| + eps) at step 1, is
      decided by the gradient's fp32 rounding noise, which two sum orders
      draw differently (the reference's sharded and unsharded programs
      alike): held within 2 x the learning rates summed, the most AdamW
      moves two runs apart;
    * with compression, an element whose int8 rounding went the other way
      (``x / scale`` within noise of a half-integer): its error feedback
      then differs by one quantum, at most 3 x the leaf's largest
      residual, and its parameter is held as above; at most
      max(2, 1/1,000 of the leaf) such elements.

    Every other element of the parameters, both moments and the error
    feedback is held at the bar; those are over 90% of the parameters
    (94% without compression, 99.8% with it: the tiny model has many
    gradients near zero).  ``moe`` is the MoE tiny config under data = 2,
    without compression: each rank routes its rows as the whole microbatch
    would (the aux loss among the metrics).  ``gather`` is tiny
    mixtral-8x7b alike, which takes the gather plan (asserted): every
    rank gathers its split parameters whole; tiny Qwen2.5-3B (``plain``,
    ``comp``) takes the split plan over its head width."""
    from repro_torch.optim.adamw import AdamWConfig
    ref, got = runs.ref, runs.ranks[0]
    for i in range(STEPS):
        for k in ("loss", "aux_loss", "tokens", "grad_norm", "lr"):
            key = f"{tag}/m{i}/{k}"
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
            for other in runs.ranks[1:]:
                assert other[key] == got[key]
    assert int(got[f"{tag}/step"]) == int(ref[f"{tag}/step"]) == STEPS
    opt = AdamWConfig(**OPT)
    lr_sum = sum(float(ref[f"{tag}/m{i}/lr"]) for i in range(STEPS))
    leaves = [k[len(f"{tag}/params/"):] for k in ref
              if k.startswith(f"{tag}/params/")]
    arch, seed = {"moe": (MOE_ARCH, 1), "gather": (GATHER_ARCH, 2)}.get(
        tag, (ARCH, 0))
    from repro_torch.launch.mesh import Mesh
    shape, axes = MESH_SHAPES["2x2"]
    split = sh.model_split(registry.get_tiny(arch),
                           Mesh(dict(zip(axes, shape))))
    assert (split is None) == (tag == "gather"), split
    assert len(leaves) == len(_weights(registry.get_tiny(arch), seed))
    held = total = 0
    for leaf in leaves:
        def pair(name):
            key = f"{tag}/{name}/{leaf}"
            return got[key].astype(np.float64), ref[key].astype(np.float64)
        flip = np.zeros(ref[f"{tag}/params/{leaf}"].shape, bool)
        if tag == "comp":
            e_got, e_ref = pair("err")
            flip = _bar(e_got, e_ref)
            assert flip.sum() <= max(2, flip.size // 1000), leaf
            assert (np.abs(e_got - e_ref)[flip]
                    <= 3 * np.abs(e_ref).max()).all(), leaf
        for name in ("mu", "nu") + (("err",) if tag == "comp" else ()):
            a, b = pair(name)
            assert not (_bar(a, b) & ~flip).any(), f"{name}/{leaf}"
        # each step's gradient, from the reference's first moments (in
        # fp32 as AdamW computes them: a zero gradient comes out zero)
        mu = [ref[f"{tag}/mu{i}/{leaf}"] for i in range(STEPS)]
        grads = [mu[0]] + [mu[i] - mu[i - 1] * np.float32(opt.b1)
                           for i in range(1, STEPS)]
        noisy = np.any([(g != 0) & (np.abs(g) < (1 - opt.b1) * 1000
                                    * opt.eps) for g in grads], axis=0)
        a, b = pair("params")
        exempt = noisy | flip
        assert not (_bar(a, b) & ~exempt).any(), f"params/{leaf}"
        assert (np.abs(a - b)[exempt] <= 2 * lr_sum + ATOL).all(), leaf
        held += int((~exempt).sum())
        total += exempt.size
    assert held > 0.9 * total, (held, total)


def test_unequal_masks_weigh_the_loss_by_global_count(runs):
    """The ranks' counts differ, so a mean of per-rank means would not
    be the reference's loss: its tokens count both ranks' targets."""
    got = runs.ranks[0]
    b = np.load(runs.work / "inputs.npz")["b0/targets"]
    assert float(got["plain/m0/tokens"]) == (b >= 0).sum() / MICRO


def test_reshard_onto_4x1_is_bitwise(runs):
    for r in runs.ranks:
        assert int(r["reshard41_differing"]) == 0
        assert int(r["reshard41_step"]) == 2
        assert int(r["reshard41_leaves"]) > 10


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group for this process, destroyed afterwards."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_reshard_onto_1x1_cpu_mesh_is_bitwise(runs, one_rank_group):
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.runtime.elastic import reshard_checkpoint
    mesh = single_device_mesh("cpu")
    tree, step = reshard_checkpoint(
        CheckpointManager(str(runs.work / "ckpt")),
        registry.get_tiny(ARCH).replace(activation_dtype="float32"), mesh)
    saved = _saved_leaves(runs.work / "ckpt" / "step_000000002")
    leaves = list(_flat(tree).values())
    assert step == 2 and len(leaves) == len(saved)
    for t, want in zip(leaves, saved):
        np.testing.assert_array_equal(t.to_local().numpy(), want)


def test_moe_under_a_data_axis_raises_naming_the_item(runs):
    """The refusal of item 8.6b is gone: under data = 2 every rank ran the
    MoE tiny config's sharded step to its end (its values are
    ``test_sharded_step_matches_reference[moe]``'s)."""
    for r in runs.ranks:
        assert str(r["moe_error"]) == ""
        assert f"moe/m{STEPS - 1}/aux_loss" in r


def _kept(y: np.ndarray) -> np.ndarray:
    """(tokens, real experts): True where the probe layer kept the
    token's assignment to the expert."""
    return y.reshape(-1, y.shape[-1])[:, :OVERFLOW["n_experts"]] != 0


def test_overflow_across_the_rank_boundary_keeps_the_reference_set(runs):
    """The probe layer (capacity 5 per chunk and expert, 3 chunks of 32
    tokens, the middle one split 16/16 between the data ranks): the ranks'
    kept assignments, together, are exactly the reference's on the whole
    microbatch; the outputs at rtol 1e-5 / atol 1e-6 and the aux loss,
    the whole microbatch's on every rank, too.  And the exchange of counts
    decides it: in the middle chunk data rank 1 drops assignments it would
    keep counting its own tokens alone (rank 0 holds the expert's first
    ones)."""
    want = runs.ref["overflow/y"]
    by_data = {int(r["coord"][0]): r for r in runs.ranks}
    got = np.concatenate([by_data[i]["overflow/y"] for i in range(2)])
    assert got.shape == want.shape
    kept = _kept(want)
    np.testing.assert_array_equal(_kept(got), kept)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for r in runs.ranks:
        np.testing.assert_allclose(r["overflow/aux"], runs.ref["overflow/aux"],
                                   rtol=RTOL, atol=ATOL)
    # each token's two experts, from the router (x·W, top 2; the softmax
    # keeps the order)
    arrays = np.load(runs.work / "inputs.npz")
    logits = arrays["probe_x"].reshape(-1, arrays["probe_x"].shape[-1]) \
        @ arrays["probe/router/kernel"]
    logits[:, OVERFLOW["n_experts"]:] = -np.inf
    top = np.argsort(-logits, axis=1, kind="stable")[:, :OVERFLOW["top_k"]]
    chosen = np.zeros_like(kept)
    np.put_along_axis(chosen, top, True, axis=1)
    assert (kept <= chosen).all() and kept.sum() < chosen.sum()
    mid = slice(32, 64)                      # rank 0: 32-47, rank 1: 48-63
    alone = np.cumsum(chosen[48:64], axis=0) <= 5     # rank 1's own count
    dropped = chosen[48:64] & alone & ~kept[48:64]
    assert dropped.any() and chosen[32:48][:, dropped.any(0)].any()
    assert (kept[mid].sum(0) <= 5).all()


# ---------------------------------------------------------------------------
# (f) bf16_reduce
# ---------------------------------------------------------------------------

def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ARCH, "gemma2-27b"])
def test_bf16_reduce_matches_reference(arch, dtype):
    """Logits with ``bf16_reduce`` against the reference's fp32 logits
    without it: within max(2%, 2x the reference's own error) of the
    scale, the LM tests' bf16 bar."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.nn import transformer as ref_tr
    rc = ref_registry.get_tiny(arch).replace(activation_dtype=dtype,
                                             bf16_reduce=True)
    pc = registry.get_tiny(arch).replace(activation_dtype=dtype,
                                         bf16_reduce=True)
    w = _nest(_weights(pc, 5), pc)
    toks = np.random.default_rng(6).integers(0, pc.vocab_size, (2, 40))
    rp = _map(jnp.asarray, w)
    want = np.asarray(ref_tr.forward(rc, rp, jnp.asarray(toks))[0])
    ref32 = np.asarray(ref_tr.forward(rc.replace(
        activation_dtype="float32", bf16_reduce=False), rp,
        jnp.asarray(toks))[0])
    got = transformer.forward(pc, module.params_from_numpy(w),
                              torch.from_numpy(toks))[0]
    ref_err = _scale_err(want, ref32)
    assert 0 < ref_err
    assert _scale_err(got.numpy(), ref32) <= max(BF16_SCALE_TOL,
                                                 2 * ref_err)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_mesh():
    """The 1 x 1 NCCL mesh of this process, its group destroyed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import single_device_mesh
    yield single_device_mesh()
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("comp", [False, True])
def test_sharded_step_on_nccl_mesh_equals_unsharded_on_card(cuda_mesh,
                                                           comp):
    """Tiny Qwen2.5-3B at microbatches 2: three sharded steps on the 1 x 1
    NCCL mesh (the first eager, then replays of its captured graph, the
    collectives inside) against three unsharded ones from the same
    weights: metrics, parameters and moments value for value."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, compress
    cfg = registry.get_tiny(ARCH).replace(microbatches=2)
    rules = sh.rules_for(cfg)
    abstract, p_sh = sh.model_param_shardings(cfg, cuda_mesh)
    o_sh = sh.state_shardings(
        abstract, module.axes_tree(transformer.model_specs(cfg)), cuda_mesh,
        rules)
    micro_sh = {k: sh.sharding_for((2, 2, 16), (None, "batch", None),
                                   cuda_mesh, rules)
                for k in ("tokens", "targets")}
    trees = []
    for sharded in (True, False):
        p = module.init_tree(transformer.model_specs(cfg), torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        st = adamw.init_state(p)
        if comp:
            st["err"] = compress.init_error_state(p)
        if sharded:
            p = sh.shard_tree(p, p_sh)
            st = sh.shard_tree(st, dict(o_sh, err=o_sh["mu"]) if comp
                               else o_sh)
        trees.append((p, st))
    step_sh = steps.make_train_step(cfg, grad_compression=comp,
                                    microbatch_shardings=micro_sh,
                                    grad_shardings=o_sh["mu"])
    step = steps.make_train_step(cfg, grad_compression=comp)
    batches = [_batches(cfg, 20 + i)[0] for i in range(3)]
    for b in batches:
        b = {k: v[:4, :16] for k, v in b.items()}
        _, _, m_sh = step_sh(*trees[0], b)
        _, _, m = step(*trees[1], b)
        for k in m:
            assert torch.equal(m_sh[k], m[k]), k
    assert step_sh.runner() is not None
    for a, b in zip(_flat(trees[0][0]).values(), _flat(trees[1][0]).values()):
        assert torch.equal(sh.local(a), b)
    for k in trees[1][1]:
        for a, b in zip(_flat({"x": trees[0][1][k]}).values(),
                        _flat({"x": trees[1][1][k]}).values()):
            assert torch.equal(sh.local(a), b)


@pytest.mark.gpu
def test_reshard_onto_the_card_mesh_is_bitwise(cuda_mesh, tmp_path):
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import reshard_checkpoint
    cfg = registry.get_tiny(ARCH)
    p = module.init_tree(transformer.model_specs(cfg),
                         torch.Generator().manual_seed(1))
    saved = {"params": p, "opt": adamw.init_state(p)}
    CheckpointManager(str(tmp_path)).save(3, saved)
    tree, step = reshard_checkpoint(CheckpointManager(str(tmp_path)), cfg,
                                    cuda_mesh)
    assert step == 3
    got, want = _flat(tree), _flat(saved)
    assert list(got) == list(want)
    for k in got:
        assert got[k].to_local().is_cuda
        assert torch.equal(got[k].to_local().cpu(), want[k])
