"""Tensor parallelism over ``model`` (``nn.tensor_parallel`` and the split
plan of ``launch.steps``) on a real mesh of processes, held against the
reference's GSPMD programs with the same shardings.

The dense configs that take the split plan, tiny gemma2-27b, stablelm-3b
and recurrentgemma-9b at fp32 activations: each rank computes on its
blocks of the attention heads, the MLP columns, the RG-LRU's channels (and
their heads) and the vocabulary rows.  One ``torch.multiprocessing`` spawn
of 4 gloo processes runs a data 2 x model 2 mesh and then a data 1 x model
4 one; the reference runs in one subprocess on 4 XLA host devices in the
same meshes.  On model 4 tiny gemma2's 2 KV heads do not divide the axis,
so ``prune_spec`` keeps them whole while its 4 query heads split: each
rank attends with its query head's group; recurrentgemma's one KV head
stays whole on both meshes (its rules), its local layer's query heads
split.  Both sides read the same numpy weights and batches, written by
this process.  ``tests/test_torch_tp_moe.py`` runs tiny qwen2-moe-a2.7b
through the same machinery.  Checks, on each mesh and config:

* one sharded train step (batch 8 x 16 in 2 microbatches, the data ranks
  holding unequal counts of targets): loss and grad norm, both moments and
  the parameters at rtol 1e-5 / atol 1e-6 (a parameter whose gradient lay
  within 1,000 x AdamW's eps of zero is held within 2 x the learning rate,
  as in ``tests/test_torch_mesh.py``);
* the sharded prefill's logits and 4 decode ticks from a zero cache, each
  lane at its own position (gemma2's window of 8 rolls): the tokens equal,
  the logits of every tick and each rank's block of every cache leaf (its
  rows and, where split, its KV heads or RG-LRU channels) at the bar of
  ``tests/test_torch_serve_mesh.py``; every tick's logits, K/V writes and
  recurrent state also against the reference's tick run from the port's
  cache before it, since a bf16 cache entry may round the other way in
  either program (the reference's then waits for the port's results);
* ``bf16_reduce`` on gemma2: the sharded prefill's logits in bf16 against
  the reference's fp32 logits within max(2%, 2 x the reference's own
  error) of the scale, ``test_bf16_reduce_matches_reference``'s bar;
* each rank holds only its blocks: its parameter bytes are the reference's
  ``params_bytes_per_device``, the plan computes on the local blocks
  themselves (no whole buffer for a split leaf), the forward of one layer
  issues exactly one all-reduce over ``model`` after the attention (or the
  RG-LRU) and one after the MLP, and a prefill no all-gather but the last
  logits';
* the plan every config takes on each mesh (``model_split``): the split
  plan's axes for the seven configs it covers, the gather plan for the
  rest, and for an RG-LRU whose heads ``prune_spec`` keeps whole while its
  channels split.  ``tests/test_torch_tp_head_dim.py`` runs the configs
  whose head width the split plan splits.
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

from repro_torch.configs import registry  # noqa: E402
from repro_torch.nn import module, transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
BF16_SCALE_TOL = 0.02                 # tests/test_torch_lm.py's bf16 bar
ARCHS = ("gemma2-27b", "stablelm-3b", "recurrentgemma-9b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
BATCH, SEQ, MICRO = 8, 16, 2
LANES, MAX_LEN, TICKS = 4, 16, 4
OPT = dict(peak_lr=1e-3, warmup_steps=2)


def _cfg(arch, **kw):
    return registry.get_tiny(arch).replace(activation_dtype="float32", **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat: dict, cfg) -> dict:
    def fill(t, prefix):
        if isinstance(t, dict):
            return {k: fill(t[k], f"{prefix}{k}/") for k in t}
        return flat[prefix[:-1]]
    return fill(transformer.model_specs(cfg), "")


def _group(arrays, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _weights(cfg, seed) -> dict:
    """The reference's ``init_tree`` rule, drawn with numpy: {path:
    array}."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale if spec.scale is not None else spec.fan_in() ** -0.5
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return _flat(module.map_specs(draw, transformer.model_specs(cfg)))


def _inputs(path: pathlib.Path, archs=ARCHS) -> dict:
    rng = np.random.default_rng(11)
    arrays = {}
    for i, arch in enumerate(archs):
        cfg = _cfg(arch)
        arrays.update({f"{arch}/w/{k}": v
                       for k, v in _weights(cfg, 20 + i).items()})
        toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        tgt = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        tgt[:, -1] = -1
        for mb in range(MICRO):          # data rank 1's rows lose 9 of 16
            tgt[mb * 4 + 2:mb * 4 + 4, :9] = -1
        arrays[f"{arch}/tokens"], arrays[f"{arch}/targets"] = toks, tgt
        if cfg.n_patches:           # a VLM's, drawn apart from the rest
            arrays[f"{arch}/patches"] = np.random.default_rng(
                12 + i).standard_normal((BATCH, cfg.n_patches,
                                         cfg.d_model)).astype(np.float32)
        for t in range(TICKS):
            arrays[f"{arch}/tok{t}"] = rng.integers(
                0, cfg.vocab_size, (LANES, 1)).astype(np.int32)
    for t in range(TICKS):
        # each lane at its own position; lane 3 passes the window of 8
        arrays[f"pos{t}"] = (np.arange(LANES) * 3 + t).astype(np.int32)
    np.savez(path, **arrays)
    return arrays


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------

REFERENCE = r"""
import json, os, sys, time
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as dr, shardings as sh, steps
from repro.nn import attention, module, transformer
from repro.optim import adamw

inp, out_path, meta = sys.argv[1:4]
arrays = dict(np.load(inp))
meta = json.loads(meta)
devs = jax.devices()
B, S, M = meta["batch"], meta["seq"], meta["micro"]
L, LANES = meta["max_len"], meta["lanes"]


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


def pinned(cfg, mesh, b):
    entry = sh.prune_spec((b,), sh.rules_for(cfg).spec(("batch",), mesh),
                          mesh)[0]
    if entry is None:
        return cfg
    return cfg.replace(batch_mesh_axes=(entry,) if isinstance(entry, str)
                       else tuple(entry))


out = {}
kept_runs = {}
for mname, shape in meta["meshes"].items():
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), devices=devs[:4],
                         axis_types=(AxisType.Auto,) * 2)
    for arch in meta["archs"]:
        if meta["cases"] is not None and [mname, arch] not in meta["cases"]:
            continue
        tag = f"{mname}/{arch}"
        keys = ("tokens", "targets") + (
            ("patches",) if f"{arch}/patches" in arrays else ())
        # one train step
        cfg = registry.get_tiny(arch).replace(activation_dtype="float32",
                                              microbatches=M)
        rules = sh.rules_for(cfg)
        abstract, p_sh = sh.model_param_shardings(cfg, mesh)
        out[f"{tag}/params_bytes"] = np.asarray(
            sh.bytes_per_device(abstract, p_sh))
        o_sh = sh.tree_shardings(adamw.abstract_state(abstract),
                                 adamw.state_axes(module.axes_tree(
                                     transformer.model_specs(cfg))), mesh,
                                 rules)
        shapes = {k: arrays[f"{arch}/{k}"].shape for k in keys}
        in_sh = {k: sh.sharding_for(shapes[k], ("batch",) + (None,) * (
            len(shapes[k]) - 1), mesh, rules) for k in keys}
        micro_sh = {k: sh.sharding_for(
            (M, B // M) + shapes[k][1:], (None, "batch") + (None,) * (
                len(shapes[k]) - 1), mesh, rules) for k in keys}
        with jax.set_mesh(mesh):
            params = jax.device_put(nest(arch + "/w", cfg), p_sh)
            state = jax.device_put(adamw.init_state(params), o_sh)
            step = jax.jit(steps.make_train_step(
                cfg, adamw.AdamWConfig(**meta["opt"]),
                microbatch_shardings=micro_sh, grad_shardings=o_sh["mu"]),
                in_shardings=(p_sh, o_sh, in_sh),
                out_shardings=(p_sh, o_sh, sh.replicated(mesh)))
            params, state, m = step(params, state, {
                k: jnp.asarray(arrays[f"{arch}/{k}"]) for k in keys})
        for k, v in m.items():
            out[f"{tag}/m/{k}"] = np.asarray(v)
        for name, tree in (("params", params), ("mu", state["mu"]),
                           ("nu", state["nu"])):
            for k, v in flat(tree).items():
                out[f"{tag}/{name}/{k}"] = v

        # the prefill, and 4 ticks from a zero cache
        cfg = pinned(registry.get_tiny(arch).replace(
            activation_dtype="float32"), mesh, LANES)
        rules = sh.rules_for(cfg)
        _, p_sh = sh.model_param_shardings(cfg, mesh)
        vocab_sh = sh.sharding_for((LANES, cfg.vocab_size),
                                   ("batch", "vocab"), mesh, rules)
        tok_in = sh.sharding_for((LANES, S), ("batch", None), mesh, rules)
        with jax.set_mesh(mesh):
            params = jax.device_put(nest(arch + "/w", cfg), p_sh)
            toks = jnp.asarray(arrays[f"{arch}/tokens"][:LANES])
            pre = {"tokens": toks}
            pre_sh = {"tokens": tok_in}
            if "patches" in keys:
                pre["patches"] = jnp.asarray(
                    arrays[f"{arch}/patches"][:LANES])
                pre_sh["patches"] = sh.sharding_for(
                    pre["patches"].shape, ("batch", None, None), mesh,
                    rules)
            f = jax.jit(steps.make_prefill(cfg), in_shardings=(p_sh, pre_sh),
                        out_shardings=vocab_sh)
            out[f"{tag}/prefill"] = np.asarray(f(params, pre))
            odd = meta["odd_lanes"]
            if odd:
                ocfg = pinned(registry.get_tiny(arch).replace(
                    activation_dtype="float32"), mesh, odd)
                pre = {k: jnp.asarray(arrays[f"{arch}/{k}"][:odd])
                       for k in pre}
                f = jax.jit(steps.make_prefill(ocfg), in_shardings=(
                    p_sh, {k: sh.sharding_for(v.shape, ("batch",) + (
                        None,) * (v.ndim - 1), mesh, rules)
                           for k, v in pre.items()}))
                out[f"{tag}/prefill_odd"] = np.asarray(f(params, pre))
            dec = ShapeConfig("d", L, LANES, "decode")
            _, c_sh = dr._cache_abstract_and_shardings(cfg, dec, mesh, rules)
            cache = jax.device_put(transformer.init_cache(cfg, LANES, L),
                                   c_sh)
            row_sh = sh.sharding_for((LANES,), ("batch",), mesh, rules)
            feed_sh = {"tokens": sh.sharding_for((LANES, 1), ("batch", None),
                                                 mesh, rules),
                       "pos": row_sh}

            def tick(p, c, fd):
                logits, c = transformer.decode_step(cfg, p, fd["tokens"], c,
                                                    fd["pos"])
                return (jnp.argmax(logits, axis=-1).astype(jnp.int32),
                        logits, c)
            run = jax.jit(tick, in_shardings=(p_sh, c_sh, feed_sh),
                          out_shardings=(row_sh, vocab_sh, c_sh),
                          donate_argnums=(1,))
            for t in range(meta["ticks"]):
                tok, logits, cache = run(params, cache, {
                    "tokens": jnp.asarray(arrays[f"{arch}/tok{t}"]),
                    "pos": jnp.asarray(arrays[f"pos{t}"])})
                out[f"{tag}/tok{t}"] = np.asarray(tok)
                out[f"{tag}/logits{t}"] = np.asarray(logits)
            for k, v in flat(cache).items():
                out[f"{tag}/cache/{k}"] = v.astype(np.float64)
            kept_runs[tag] = (mesh, params, p_sh, c_sh, feed_sh, cache, cfg)
        if arch != "gemma2-27b":
            continue
        # bf16_reduce, in bf16 activations
        cfg = pinned(registry.get_tiny(arch).replace(
            activation_dtype="bfloat16", bf16_reduce=True), mesh, LANES)
        with jax.set_mesh(mesh):
            f = jax.jit(steps.make_prefill(cfg),
                        in_shardings=(p_sh, {"tokens": tok_in}),
                        out_shardings=vocab_sh)
            out[f"{tag}/prefill_bf16"] = np.asarray(
                f(params, {"tokens": toks}), np.float32)

# each tick again with the port's K/V entries: from the port's cache
# after the tick, the reference's writes of K and V left out (it still
# writes the positions), so it attends to the same bf16 values as the
# port's tick did, whichever way the port's sum order rounded them; a
# recurrent state (an RG-LRU's h and conv), which the tick reads and
# rewrites, from the port's cache before the tick, and the state it writes
# kept for the port's to be held to.  A full cache's K/V entry that the
# reference computes there, from the port's entries of the layers before,
# goes into the cache's last slot, which no tick attends to (every lane's
# position stays below it), for the port's entry to be held to.  And each
# tick with its
# writes from the port's whole cache before it, for the K/V entries the
# reference writes from the port's state.  It waits for the port's results
# (written when its 4 processes end)
files = [os.path.join(meta["port_dir"], f"rank{r}.npz") for r in range(4)]
deadline = time.time() + 500
while not all(os.path.exists(f) for f in files):
    if time.time() > deadline:
        raise SystemExit("the port's ranks wrote no results")
    time.sleep(0.2)
ranks = [dict(np.load(f)) for f in files]
write_at = attention._write_at


SHADOW = L - 1
assert max(int(arrays[f"pos{t}"].max()) for t in range(meta["ticks"])) \
    < SHADOW


def keep_kv(cache_arr, val, slot):
    if jnp.issubdtype(cache_arr.dtype, jnp.floating):
        if cache_arr.shape[1] == L:        # a full cache: its shadow slot
            return write_at(cache_arr, val, jnp.full_like(slot, SHADOW))
        return cache_arr
    return write_at(cache_arr, val, slot)


def like(tree, leaves, path=""):
    if isinstance(tree, dict):
        return {k: like(tree[k], leaves, path + k + "/") for k in tree}
    return leaves[path[:-1]]


# the port's whole cache: before tick t, or where kept its K/V and
# positions after it
def port_cache(tag, cache, t, kept, cfg):
    after = "cache" if t == meta["ticks"] - 1 else f"cache_after{t}"
    start = flat(transformer.init_cache(cfg, LANES, L))
    whole = {}
    for leaf, was in flat(cache).items():
        a = np.zeros(was.shape, np.float64)
        before = not kept or leaf.split("/")[-1] not in ("k", "v", "kpos")
        if before and t == 0:           # the cache the ticks start from
            whole[leaf] = jnp.asarray(start[leaf].astype(was.dtype))
            continue
        at = f"cache_after{t - 1}" if before else after
        for r in ranks:
            a[tuple(slice(lo, hi) for lo, hi in
                    r[f"{tag}/cache_block/{leaf}"])] = r[f"{tag}/{at}/{leaf}"]
        whole[leaf] = jnp.asarray(a.astype(was.dtype))
    return like(cache, whole)


for kept in (True, False):
    attention._write_at = keep_kv if kept else write_at
    for tag, (mesh, params, p_sh, c_sh, feed_sh, cache, cfg) in \
            kept_runs.items():
        arch = tag.split("/")[1]

        def tick(p, c, fd, cfg=cfg):
            return transformer.decode_step(cfg, p, fd["tokens"], c,
                                           fd["pos"])
        run = jax.jit(tick, in_shardings=(p_sh, c_sh, feed_sh),
                      out_shardings=(sh.sharding_for(
                          (LANES, cfg.vocab_size), ("batch", "vocab"), mesh,
                          sh.rules_for(cfg)), c_sh))
        for t in range(meta["ticks"]):
            with jax.set_mesh(mesh):
                logits, res = run(params, jax.device_put(
                    port_cache(tag, cache, t, kept, cfg), c_sh),
                    {"tokens": jnp.asarray(arrays[f"{arch}/tok{t}"]),
                     "pos": jnp.asarray(arrays[f"pos{t}"])})
            if kept:
                out[f"{tag}/kept_logits{t}"] = np.asarray(logits)
            for leaf, v in flat(res).items():
                if kept and leaf.split("/")[-1] in ("k", "v") and \
                        v.shape[-3] == L:
                    out[f"{tag}/shadow{t}/{leaf}"] = \
                        v[..., SHADOW, :, :].astype(np.float64)
                # kept: the recurrent state the tick writes with the
                # port's K/V entries; else the K/V entries it writes
                if (leaf.split("/")[-1] in ("k", "v")) != kept and \
                        jnp.issubdtype(v.dtype, jnp.floating):
                    out[f"{tag}/same_state{t}/{leaf}"] = v.astype(np.float64)
attention._write_at = write_at
np.savez(out_path, **out)
print("REFERENCE DONE")
"""


def _reference(inputs: pathlib.Path, out: pathlib.Path, archs=ARCHS,
               cases=None, opts=None) -> subprocess.Popen:
    """The reference's programs, then its ticks again from the port's
    caches, which it waits for in ``out``'s folder; ``cases``: the (mesh,
    arch) pairs to run (None: every one); ``opts``: :func:`spawn`'s."""
    opts = opts or {}
    meta = {"archs": archs, "cases": cases, "meshes": MESHES,
            "batch": BATCH, "seq": SEQ, "odd_lanes": opts.get("odd_lanes"),
            "micro": opts.get("micro", MICRO), "max_len": MAX_LEN,
            "lanes": LANES,
            "ticks": TICKS, "opt": OPT, "port_dir": str(out.parent)}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(out),
         json.dumps(meta)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# the port, in 4 spawned gloo processes
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, port: int, inputs: str, out_dir: str,
            archs=ARCHS, extra=None, cases=None, opts=None):
    """One rank of both meshes: its results into ``out_dir/rank<r>.npz``
    (the train step's whole tensors from rank 0); ``extra(mname, mesh,
    arrays)``, a caller's further checks on each mesh, adds its own;
    ``cases`` and ``opts``: :func:`spawn`'s."""
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = _rank_checks(rank, np.load(inputs), archs, extra, cases,
                           opts or {})
    finally:
        dist.destroy_process_group()
    # whole or not at all: the reference reads it once it exists
    tmp = pathlib.Path(out_dir) / f"rank{rank}.part.npz"
    np.savez(tmp, **res)
    os.replace(tmp, pathlib.Path(out_dir) / f"rank{rank}.npz")


def _rank_checks(rank: int, arrays, archs=ARCHS, extra=None,
                 cases=None, opts=None) -> dict:
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.optim import adamw

    res: dict = {}
    for mname, shape in MESHES.items():
        mesh = mesh_lib.make_test_mesh(shape, ("data", "model"), "cpu")
        res[f"{mname}/coord"] = np.array(mesh.coordinate())
        if extra is not None:
            res.update(extra(mname, mesh, arrays))
        for arch in archs:
            if cases is not None and [mname, arch] not in cases:
                continue
            tag = f"{mname}/{arch}"
            keys = ("tokens", "targets") + (
                ("patches",) if f"{arch}/patches" in arrays else ())
            micro = (opts or {}).get("micro", MICRO)
            cfg = _cfg(arch, microbatches=micro)
            rules = sh.rules_for(cfg)
            abstract, p_sh = sh.model_param_shardings(cfg, mesh)
            axes = module.axes_tree(transformer.model_specs(cfg))
            o_sh = sh.state_shardings(abstract, axes, mesh, rules)
            micro_sh = {k: sh.sharding_for((micro, BATCH // micro, SEQ),
                                           (None, "batch", None), mesh,
                                           rules)
                        for k in ("tokens", "targets")}
            w = module.params_from_numpy(_nest(_group(arrays, arch + "/w"),
                                               cfg))
            params = sh.shard_tree(module.map_tree(torch.clone, w), p_sh)
            state = sh.shard_tree(adamw.init_state(w), o_sh)
            res[f"{tag}/params_bytes"] = np.array(sum(
                sh.local(t).numel() * t.element_size()
                for t in module.tree_leaves(params)))
            res.update(_layout(tag, cfg, mesh, params))
            from repro_torch.launch import steps
            step = steps.make_train_step(
                cfg, adamw.AdamWConfig(**OPT),
                microbatch_shardings=micro_sh, grad_shardings=o_sh["mu"])
            params, state, m = step(params, state, {
                k: arrays[f"{arch}/{k}"] for k in keys})
            for k, v in m.items():
                res[f"{tag}/m/{k}"] = v.numpy()
            for name, tree in (("params", params), ("mu", state["mu"]),
                               ("nu", state["nu"])):
                whole = _flat(module.map_tree(lambda t: t.full_tensor(),
                                              tree))
                if rank == 0:
                    for k, v in whole.items():
                        res[f"{tag}/{name}/{k}"] = v.numpy()
            res.update(_serve(tag, arch, mesh, arrays,
                              (opts or {}).get("odd_lanes")))
    return res


def _layout(tag: str, cfg, mesh, params) -> dict:
    """The split plan's layout on this rank: the tree the compute reads
    holds the local blocks themselves; the collectives of one layer's
    forward, and of a prefill, by kind, group size and bytes."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.launch.op_inventory import OpInventory
    from repro_torch.nn import tensor_parallel as tp
    plan = steps.make_prefill(cfg).prepare(params)
    computed = module.tree_leaves(plan.full_tree())
    local = [sh.local(t) for t in module.tree_leaves(params)]
    split = [tuple(t.shape) != tuple(p.shape)
             for t, p in zip(local, module.tree_leaves(params))]
    out = {f"{tag}/plan": np.array(plan.model_split),
           f"{tag}/n_split": np.array(sum(split)),
           f"{tag}/computes_on_blocks": np.array(all(
               a is b for a, b in zip(computed, local)))}
    kind = cfg.attn_pattern[0]
    layer = module.map_tree(lambda a: a[0], plan.full_tree()["blocks"]["0"])
    x = torch.randn(2, SEQ, cfg.d_model,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), tp.model_shard(plan.model), OpInventory() as inv:
        transformer.apply_block(cfg, kind, layer, x)
    with torch.no_grad(), OpInventory() as pre:
        steps.make_prefill(cfg)(params, {"tokens": np.zeros(
            (LANES, SEQ), np.int32)})
    for name, report in (("layer", inv.report()), ("prefill",
                                                    pre.report())):
        out[f"{tag}/{name}_collectives"] = np.array([
            [c.kind == "all-reduce", c.group_size, c.operand_bytes]
            for c in report.collectives], np.int64).reshape(-1, 3)
        out[f"{tag}/{name}_kinds"] = np.array(
            [c.kind for c in report.collectives], dtype=str)
    return out


def _serve(tag: str, arch: str, mesh, arrays, odd_lanes=None) -> dict:
    """The sharded prefill's logits (also at ``odd_lanes`` rows where
    given), 4 ticks' tokens and logits, and this rank's cache blocks with
    their slices of the whole leaves."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    cfg = _cfg(arch)
    _, p_sh = sh.model_param_shardings(cfg, mesh)
    params = sh.shard_tree(module.params_from_numpy(_nest(
        _group(arrays, arch + "/w"), cfg)), p_sh)
    toks = arrays[f"{arch}/tokens"][:LANES]
    pre = {"tokens": toks}
    if f"{arch}/patches" in arrays:
        pre["patches"] = arrays[f"{arch}/patches"][:LANES]
    out = {f"{tag}/prefill": steps.make_prefill(cfg)(
        params, pre).to_local().numpy()}
    if odd_lanes:
        out[f"{tag}/prefill_odd"] = steps.make_prefill(cfg)(
            params, {k: v[:odd_lanes] for k, v in pre.items()}
        ).to_local().numpy()
    cache = sh.init_sharded_cache(cfg, LANES, MAX_LEN, mesh)
    step = steps.make_serve_step(cfg)
    for t in range(TICKS):
        tok, cache = step(params, cache, {"tokens": arrays[f"{arch}/tok{t}"],
                                          "pos": arrays[f"pos{t}"]})
        out[f"{tag}/tok{t}"] = tok.to_local().numpy()
        out[f"{tag}/logits{t}"] = step.logits().to_local().numpy()
        if t + 1 < TICKS:
            for k, v in _flat(cache).items():
                out[f"{tag}/cache_after{t}/{k}"] = \
                    sh.local(v).to(torch.float64).numpy()
    for k, v in _flat(cache).items():
        out[f"{tag}/cache/{k}"] = sh.local(v).to(torch.float64).numpy()
        out[f"{tag}/cache_block/{k}"] = np.array([
            [b.start, b.stop] for b in mesh.block(sh.sharding_of(v, mesh),
                                                  v.shape)])
    if arch == "gemma2-27b":
        bcfg = registry.get_tiny(arch).replace(activation_dtype="bfloat16",
                                               bf16_reduce=True)
        out[f"{tag}/prefill_bf16"] = steps.make_prefill(bcfg)(
            params, {"tokens": toks}).to_local().to(torch.float32).numpy()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(work: pathlib.Path, archs=ARCHS, extra=None,
          arrays=None, cases=None, opts=None) -> types.SimpleNamespace:
    """(the reference's results, each rank's results, the inputs) of
    ``archs``: the reference's subprocess and the 4-rank spawn at once, in
    ``work``; ``arrays`` join the inputs both sides read; ``cases``, a
    list of (mesh, arch) pairs, keeps only those (None: every mesh for
    every arch); ``opts``: {"micro": the train step's microbatches (of
    the batch of 8; default 2), "odd_lanes": a second prefill on the
    batch's first rows, that many}."""
    cases = None if cases is None else [list(c) for c in cases]
    import torch.multiprocessing as mp
    inputs = work / "inputs.npz"
    both = _inputs(inputs, archs)
    if arrays:
        both.update(arrays)
        np.savez(inputs, **both)
    proc = _reference(inputs, work / "reference.npz", archs, cases, opts)
    try:
        mp.start_processes(_worker, args=(4, _free_port(), str(inputs),
                                          str(work), archs, extra, cases,
                                          opts),
                           nprocs=4, start_method="spawn")
        _, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    ref = dict(np.load(work / "reference.npz"))
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]
    return types.SimpleNamespace(ref=ref, ranks=ranks, arrays=both)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    return spawn(tmp_path_factory.mktemp("tp"))


def _bar(got, want):
    """Elements outside rtol 1e-5 / atol 1e-6."""
    return np.abs(got - want) > ATOL + RTOL * np.abs(want)


def _hold(got, want, what: str = "", bf16: bool = False) -> None:
    """``tests/test_torch_serve_mesh.py``'s bar: rtol 1e-5 and atol 1e-6 of
    the tensor's scale; a bf16 cache leaf at most max(2, 1/1,000 of it)
    outside, each within one bf16 ulp."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    off = np.abs(got - want) > atol + RTOL * np.abs(want)
    if bf16:
        assert off.sum() <= max(2, off.size // 1000), (what, off.sum())
        assert (np.abs(got - want)[off] <= 2.0 ** -7 * np.abs(want)[off]
                ).all(), what
    else:
        assert not off.any(), (what, off.sum(), np.abs(got - want).max())


def _rows(r: dict, mname: str, n: int) -> slice:
    d, ways = int(r[f"{mname}/coord"][0]), MESHES[mname][0]
    return slice(d * n // ways, (d + 1) * n // ways)


CASES = [(m, a) for m in MESHES for a in ARCHS]


def want_split(cfg, ways: int) -> int:
    """The leaves the split plan splits on ``ways`` ranks of ``model``, by
    hand: an attention's q and o (and q's bias), its k and v (and biases)
    where the KV heads divide the axis or the rules split the head width;
    an RG-LRU's ten; an MLP's three,
    an MoE's three experts and three shared; the table, the unembedding."""
    head_dim = dict(cfg.rules_overrides).get("head_dim") == "model"
    kv = head_dim or cfg.n_kv_heads % ways == 0
    per = {"rglru": 10,
           "global": (2 + 2 * kv) * (1 + cfg.qkv_bias) - cfg.qkv_bias}
    per["local"] = per["global"]
    ffn = 3 + 3 * bool(cfg.n_shared_experts) if cfg.n_experts else 3
    kinds = list(cfg.attn_pattern) + [cfg.attn_pattern[j] for j in range(
        cfg.n_remainder_layers)]
    return sum(per[k] + ffn for k in kinds) + 1 + (not cfg.tie_embeddings)


@pytest.mark.parametrize("mname,arch", CASES)
def test_split_plan_holds_only_its_blocks(runs, mname, arch):
    """The split plan on every rank: parameter bytes the reference's
    ``params_bytes_per_device``; the compute reads the local blocks
    themselves, the split leaves' (every attention, MLP, RG-LRU and
    vocabulary leaf of the tiny model but the KV heads that do not divide
    the axis: tiny gemma2's on model 4, recurrentgemma's one) smaller than
    whole."""
    tag = f"{mname}/{arch}"
    cfg = _cfg(arch)
    for r in runs.ranks:
        assert str(r[f"{tag}/plan"]) == "compute"
        assert int(r[f"{tag}/params_bytes"]) == \
            int(runs.ref[f"{tag}/params_bytes"])
        assert bool(r[f"{tag}/computes_on_blocks"])
        assert int(r[f"{tag}/n_split"]) == want_split(cfg,
                                                      MESHES[mname][1])


@pytest.mark.parametrize("mname,arch", CASES)
def test_collectives_are_the_model_axis_reductions(runs, mname, arch):
    """One layer's forward: two all-reduces over the ``model`` group of
    (rows, seq, d) fp32, after the attention and after the MLP, nothing
    else.  A prefill: the embedding's all-reduce, two per layer, and the
    last logits' all-gather (this rank's rows and vocabulary columns); no
    parameter is gathered."""
    cfg = _cfg(arch)
    ways = MESHES[mname][1]
    act = 2 * SEQ * cfg.d_model * 4
    rows = LANES // MESHES[mname][0]
    for r in runs.ranks:
        layer = r[f"{mname}/{arch}/layer_collectives"]
        assert layer.tolist() == [[1, ways, act]] * 2
        pre = r[f"{mname}/{arch}/prefill_collectives"]
        reduces = [c for c in pre.tolist() if c[0]]
        gathers = [c for c in pre.tolist() if not c[0]]
        assert len(reduces) == 1 + 2 * cfg.n_layers
        assert all(c[1] == ways for c in reduces)
        assert gathers == [[0, ways, rows * cfg.vocab_size // ways * 4]]


@pytest.mark.parametrize("mname,arch", CASES)
def test_sharded_train_step_matches_reference(runs, mname, arch):
    """Metrics equal on every rank and at the bar against the reference's;
    both moments at the bar everywhere; the parameters at the bar but
    where a gradient lay within noise of zero (module docstring)."""
    from repro_torch.optim.adamw import AdamWConfig
    tag = f"{mname}/{arch}"
    ref, got = runs.ref, runs.ranks[0]
    for k in ("loss", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(got[f"{tag}/m/{k}"], ref[f"{tag}/m/{k}"],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        for other in runs.ranks[1:]:
            assert other[f"{tag}/m/{k}"] == got[f"{tag}/m/{k}"], k
    opt = AdamWConfig(**OPT)
    lr = float(ref[f"{tag}/m/lr"])
    leaves = [k[len(f"{tag}/params/"):] for k in ref
              if k.startswith(f"{tag}/params/")]
    assert len(leaves) == len(_weights(_cfg(arch), 0))
    held = total = 0
    for leaf in leaves:
        def pair(name):
            key = f"{tag}/{name}/{leaf}"
            return got[key].astype(np.float64), ref[key].astype(np.float64)
        for name in ("mu", "nu"):
            a, b = pair(name)
            assert not _bar(a, b).any(), f"{name}/{leaf}"
        g = ref[f"{tag}/mu/{leaf}"]                 # (1 - b1) x the grad
        noisy = (g != 0) & (np.abs(g) < (1 - opt.b1) * 1000 * opt.eps)
        a, b = pair("params")
        assert not (_bar(a, b) & ~noisy).any(), f"params/{leaf}"
        assert (np.abs(a - b)[noisy] <= 2 * lr + ATOL).all(), leaf
        held += int((~noisy).sum())
        total += noisy.size
    assert held > 0.9 * total, (held, total)


def _off_bf16(got, want) -> np.ndarray:
    """Where a bf16 cache leaf holds the other rounding of the reference's
    value: outside :func:`_hold`'s bar (bf16 values that differ at all
    differ by an ulp, far outside it)."""
    atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    return np.abs(got - want) > atol + RTOL * np.abs(want)


def _rounded_other_way(ranks, tag, cfg, cache) -> np.ndarray:
    """(ticks, lanes): whether a K/V entry that the lane's tick attends to
    (any layer and KV head, on whichever rank holds it; any slot written
    up to that tick) holds the other bf16 rounding of ``cache``'s (the
    whole leaves of a reference run, by leaf name)."""
    out = np.zeros((TICKS, LANES), bool)
    for r in ranks:
        for i, kind in enumerate(cfg.attn_pattern):
            if kind not in ("global", "local"):
                continue
            size = cfg.window if kind == "local" else MAX_LEN
            for n in ("k", "v"):
                leaf = f"blocks/{i}/{n}"
                block = tuple(slice(a, b) for a, b in
                              r[f"{tag}/cache_block/{leaf}"])
                off = _off_bf16(r[f"{tag}/cache/{leaf}"],
                                cache[leaf][block])
                slots = off.any(axis=(0, 3, 4))         # (lanes, slots)
                for j, lane in enumerate(range(block[1].start,
                                               block[1].stop)):
                    for t in range(TICKS):
                        # lane b's position at tick u is 3 b + u (_inputs)
                        seen = {(3 * lane + u) % size for u in range(t + 1)}
                        out[t, lane] |= slots[j, sorted(seen)].any()
    return out


def _tick_entries(cfg, leaf: str, block: tuple, t: int) -> np.ndarray:
    """Over a rank's block of a K/V leaf: True at the entries tick ``t``
    writes for its lanes (lane b at position 3 b + t, ``_inputs``; its slot
    in a local layer's window rolls)."""
    stacked = leaf.startswith("blocks/")
    kind = cfg.attn_pattern[int(leaf.split("/")[1])]
    lanes, slots = block[int(stacked)], block[1 + int(stacked)]
    size = slots.stop - slots.start
    mask = np.zeros(tuple(b.stop - b.start for b in block), bool)
    for j, lane in enumerate(range(lanes.start, lanes.stop)):
        pos = 3 * lane + t
        slot = pos % size if kind == "local" and cfg.window else \
            min(pos, size - 1)
        mask[(slice(None),) * stacked + (j, slot)] = True
    return mask


@pytest.mark.parametrize("mname,arch", CASES)
def test_sharded_prefill_and_ticks_match_reference(runs, mname, arch):
    """Each rank's rows of the prefill's and every tick's logits, whole
    over the vocabulary, and the tokens; after 4 ticks each rank's block
    of every cache leaf against that block of the reference's.

    The K/V cache is bf16: a value the two sum orders leave within noise
    of a rounding boundary rounds the other way (one bf16 ulp), and every
    later tick of that lane attends to it; the reference's sharded program
    makes such entries where its own unsharded one does not.  So every
    tick's logits are held at the bar against the reference's tick run
    from the port's own cache before it (the same bf16 entries in), and
    the logits of a lane whose cache up to that tick holds the
    reference's values exactly also against the reference's own ticks.
    The K/V entries alike: the ones every tick writes against the ones the
    reference's tick writes from the port's whole cache before it, and in
    a full cache also against the ones it computes from the port's
    entries of the tick's earlier layers too (written into the slot no
    tick attends to); and every entry against the reference's own cache,
    each within one bf16 ulp, with at most max(2, 1/1,000 of the leaf)
    outside the bar but for the ones a lane wrote while its cache held
    the other rounding (tiny qwen2-moe on model 4: lane 3's layer-0 V
    entry of tick 1 rounds the other way, and two of its layer-1 V
    entries of tick 2 follow it, each one ulp off).  The recurrent state
    (an RG-LRU's ``h`` and ``conv``) after every tick at the bar against
    the state the reference's tick writes from the port's state before it
    and the port's K/V entries of the tick, and after the last against
    the reference's own.  The tokens equal the reference's own."""
    tag = f"{mname}/{arch}"
    ref, cfg = runs.ref, _cfg(arch)
    leaves = sorted(k[len(tag) + 7:] for k in ref
                    if k.startswith(f"{tag}/cache/"))
    assert len(leaves) >= 2
    other = _rounded_other_way(runs.ranks, tag, cfg, {
        leaf: ref[f"{tag}/cache/{leaf}"] for leaf in leaves})
    for r in runs.ranks:
        rows = _rows(r, mname, LANES)
        _hold(r[f"{tag}/prefill"], ref[f"{tag}/prefill"][rows], "prefill")
        for t in range(TICKS):
            np.testing.assert_array_equal(r[f"{tag}/tok{t}"],
                                          ref[f"{tag}/tok{t}"][rows])
            got = r[f"{tag}/logits{t}"]
            kept = ref[f"{tag}/kept_logits{t}"][rows]
            for j, lane in enumerate(range(rows.start, rows.stop)):
                _hold(got[j], kept[j], f"logits{t} lane {lane}, the "
                                        f"port's K/V entries")
                if not other[t, lane]:
                    _hold(got[j], ref[f"{tag}/logits{t}"][lane],
                          f"logits{t} lane {lane}")
        for leaf in leaves:
            block = tuple(slice(a, b) for a, b in
                          r[f"{tag}/cache_block/{leaf}"])
            got, want = r[f"{tag}/cache/{leaf}"], \
                ref[f"{tag}/cache/{leaf}"][block]
            if leaf.split("/")[-1] not in ("k", "v"):
                _hold(got, want, leaf)
                for t in range(TICKS * (leaf.split("/")[-1] != "kpos")):
                    after = "cache" if t == TICKS - 1 else f"cache_after{t}"
                    _hold(r[f"{tag}/{after}/{leaf}"],
                          ref[f"{tag}/same_state{t}/{leaf}"][block],
                          f"{leaf} tick {t}, from the port's state")
                continue
            off = _off_bf16(got, want)
            assert (np.abs(got - want)[off] <= 2.0 ** -7 * np.abs(want)[off]
                    ).all(), leaf
            held = np.ones(got.shape, bool)
            lane_dim = int(leaf.startswith("blocks/"))
            for t in range(TICKS):
                mask = _tick_entries(cfg, leaf, block, t)
                after = "cache" if t == TICKS - 1 else f"cache_after{t}"
                entries = r[f"{tag}/{after}/{leaf}"][mask]
                _hold(entries,
                      ref[f"{tag}/same_state{t}/{leaf}"][block][mask],
                      f"{leaf} tick {t}, from the port's cache", bf16=True)
                if f"{tag}/shadow{t}/{leaf}" in ref:
                    # and from the port's entries of the tick's earlier
                    # layers too
                    _hold(entries, ref[f"{tag}/shadow{t}/{leaf}"][
                        block[:lane_dim + 1] + block[lane_dim + 2:]].ravel(),
                        f"{leaf} tick {t}, from the port's entries",
                        bf16=True)
                for j, lane in enumerate(range(rows.start, rows.stop)):
                    if other[t, lane]:
                        held[(slice(None),) * lane_dim + (j,)] &= \
                            ~mask[(slice(None),) * lane_dim + (j,)]
            _hold(got[held], want[held], leaf, bf16=True)
    assert other.sum() <= other.size // 2, other


def test_cache_blocks_split_the_kv_heads(runs):
    """The decode cache takes the rules' split: on model 2 each rank holds
    one of tiny gemma2's 2 KV heads and 2 of stablelm's 4; on model 4
    gemma2's 2 stay whole, stablelm's split 4 ways.  A local layer's
    window rolled (positions past its 8 slots)."""
    for r in runs.ranks:
        for mname, arch, want in (("2x2", "gemma2-27b", 1),
                                  ("2x2", "stablelm-3b", 2),
                                  ("1x4", "gemma2-27b", 2),
                                  ("1x4", "stablelm-3b", 1)):
            assert r[f"{mname}/{arch}/cache/blocks/0/k"].shape[3] == want
    kpos = runs.ref["2x2/gemma2-27b/cache/blocks/0/kpos"]
    assert kpos.max() >= 8 and kpos.shape[-1] == 8


def test_cache_blocks_split_the_rglru_channels(runs):
    """Recurrentgemma's decode cache under the split plan: each rank's
    ``h`` and ``conv`` of every RG-LRU layer (stacked and remainder) hold
    its block of the 64 channels, 32 on model 2 and 16 on model 4, at its
    model index, and moved; its local layer's one KV head stays whole."""
    arch, cfg = "recurrentgemma-9b", _cfg("recurrentgemma-9b")
    width = cfg.lru_width
    for mname, (_, ways) in MESHES.items():
        tag = f"{mname}/{arch}"
        for r in runs.ranks:
            m = int(r[f"{mname}/coord"][1])
            for leaf in ("blocks/0/h", "blocks/1/conv", "extra/0/h",
                         "extra/1/conv"):
                got = r[f"{tag}/cache/{leaf}"]
                lo, hi = r[f"{tag}/cache_block/{leaf}"][-1]
                assert got.shape[-1] == width // ways, (leaf, got.shape)
                assert (lo, hi) == (m * width // ways,
                                    (m + 1) * width // ways)
                assert np.abs(got).max() > 0, leaf
            assert r[f"{tag}/cache/blocks/2/k"].shape[3] == cfg.n_kv_heads


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("mname", MESHES)
def test_bf16_reduce_sharded_matches_reference(runs, mname):
    """Gemma2's sharded prefill in bf16 with ``bf16_reduce`` (each rank's
    partial rounded to bf16 before the all-reduce) against the reference's
    fp32 logits: within max(2%, 2 x the reference's own bf16_reduce
    error) of the scale."""
    tag = f"{mname}/gemma2-27b"
    ref32 = runs.ref[f"{tag}/prefill"]
    ref_err = _scale_err(runs.ref[f"{tag}/prefill_bf16"], ref32)
    assert 0 < ref_err
    for r in runs.ranks:
        rows = _rows(r, mname, LANES)
        assert _scale_err(r[f"{tag}/prefill_bf16"], ref32[rows]) <= max(
            BF16_SCALE_TOL, 2 * ref_err)


def _leaves_of(cfg) -> dict:
    """The config's parameter leaves' axes, by path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            out[path] = tuple(t.axes)
    walk(transformer.model_specs(cfg), ())
    return out


#: the configs the split plan covers, and the logical axes it splits
SPLIT_PLANS = {"gemma2-27b": {"heads", "kv_heads", "mlp", "vocab"},
               "stablelm-3b": {"heads", "kv_heads", "mlp", "vocab"},
               "recurrentgemma-9b": {"heads", "mlp", "vocab"},
               "qwen2-moe-a2.7b": {"heads", "kv_heads", "mlp", "vocab",
                                   "experts"},
               "qwen2.5-3b": {"head_dim", "mlp", "vocab"},
               "qwen2-7b": {"head_dim", "mlp", "vocab"},
               "qwen2-vl-2b": {"head_dim", "mlp", "vocab"}}


def test_split_leaves_are_the_configs_model_axis_leaves():
    """``nn.tensor_parallel.SPLIT_LEAVES`` against the specs of the seven
    configs of the split plan (and with q/k/v biases): every leaf with a
    ``heads``, ``kv_heads``, ``head_dim``, ``mlp``, ``experts`` or
    ``vocab`` axis is in the table under that axis, and every entry of
    the table names such a leaf."""
    from repro_torch.nn import tensor_parallel as tp
    split = {"heads", "kv_heads", "head_dim", "mlp", "experts", "vocab"}
    named = set()
    for arch in SPLIT_PLANS:
        for cfg in (_cfg(arch), _cfg(arch, qkv_bias=True)):
            for path, axes in _leaves_of(cfg).items():
                for ax in split.intersection(axes):
                    assert tp.splits_leaf(path, ax), (arch, path, ax)
                    named |= {(tail, a) for tail, a in tp.SPLIT_LEAVES
                              if a == ax and path[-len(tail):] == tail}
    assert named == set(tp.SPLIT_LEAVES)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (1, 4), (16, 16)])
def test_every_config_takes_its_plan(mesh_shape):
    """``launch.shardings.model_split`` at full width on 1 x 1, data 2 x
    model 2, data 1 x model 4 and 16 x 16: the split plan's axes for
    gemma2-27b, stablelm-3b, recurrentgemma-9b, qwen2-moe-a2.7b, and
    over ``head_dim`` qwen2.5-3b, qwen2-7b and qwen2-vl-2b; the gather
    plan (None) for every other config of the registry: mixtral's experts
    split within (``expert_mlp``), xlstm-1.3b's ``head_dim`` running
    through the sLSTM (its leaves not in the table), whisper-tiny an
    encoder-decoder."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings as sh
    mesh = mesh_lib.Mesh(dict(zip(("data", "model"), mesh_shape)))
    gather = {"mixtral-8x7b", "xlstm-1.3b", "whisper-tiny"}
    assert set(registry.ARCH_IDS) == gather | set(SPLIT_PLANS)
    for arch in registry.ARCH_IDS:
        got = sh.model_split(registry.get_config(arch), mesh)
        want = SPLIT_PLANS.get(arch)
        assert (got if got is None else set(got)) == want, (arch, got)


def test_misaligned_blocks_keep_the_gather_plan():
    """Where the blocks a layer combines would not line up, the gather
    plan: tiny recurrentgemma-9b on model 8 (its 4 heads kept whole by
    ``prune_spec``, its 64 channels split, so a rank's channels would not
    be its gates' heads), or with 2 heads on model 4; tiny qwen2-moe-a2.7b
    on 16 x 16 (its 8 experts whole, its shared expert's 64 columns
    split).  On model 4 both take the split plan, where tiny qwen2-moe's
    last rank holds only padding experts (6 and 7 of 8)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings as sh
    rg, moe = (registry.get_tiny(a) for a in ("recurrentgemma-9b",
                                              "qwen2-moe-a2.7b"))
    on = lambda **shape: mesh_lib.Mesh(shape)  # noqa: E731
    assert sh.model_split(rg, on(data=1, model=8)) is None
    assert sh.model_split(rg.replace(n_heads=2, head_dim=32),
                          on(data=1, model=4)) is None
    assert sh.model_split(moe, on(data=16, model=16)) is None
    assert set(sh.model_split(rg, on(data=1, model=4))) == \
        SPLIT_PLANS["recurrentgemma-9b"]
    assert set(sh.model_split(moe, on(data=1, model=4))) == \
        SPLIT_PLANS["qwen2-moe-a2.7b"]
    assert moe.n_experts_padded // 4 * 3 >= moe.n_experts
