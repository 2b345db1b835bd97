"""The port's sharded prefill and serve step (``launch.steps.make_prefill``
and ``make_serve_step`` on DTensor parameters and cache) on a real mesh of
processes, held against the reference's jitted with the same shardings.

One ``torch.multiprocessing`` spawn of 4 gloo processes runs a 2 x 2
(data, model) mesh on the CPU; the reference runs in one subprocess on 4
XLA host devices in a 2 x 2 mesh, its steps jitted with the
shardings its dry-run gives (the cache's from ``cache_specs`` and
``cache_axes``).  Both get the same numpy inputs, written by this process.
The configs are the tiny qwen2.5-3b, qwen2-moe-a2.7b, recurrentgemma-9b
(RG-LRU and windowed attention, remainder layers) and whisper-tiny, with
fp32 activations.  Checks:

* the prefill's logits, each rank's rows of a DTensor split over ``data``,
  at the bar below against the reference's rows;
* 4 decode steps from a zero cache (whisper's encoder output drawn), each
  lane at its own position (recurrentgemma's window rolls): the tokens
  equal, and each rank's cache block at the bar against that block of the
  reference's cache: its rows of every leaf, whole under the gather plan
  (whisper-tiny), and under the split plan its head-width columns
  (qwen2.5-3b), KV heads (qwen2-moe-a2.7b) and RG-LRU channels
  (recurrentgemma-9b) as well;
  and recurrentgemma's recurrent state after every step against the
  state the reference's step writes from the port's cache (the
  reference's subprocess then waits for the port's results);
* one MoE tick at batch 8 and capacity factor 0.5 (capacity 1 per expert
  over the 16 assignments): the tokens equal and the logits at the bar,
  and data rank 1 drops assignments it would keep counting its own lanes
  alone (data rank 0's lanes fill the experts first).

The bar (:func:`_hold`): rtol 1e-5 and atol 1e-6 of the tensor's scale
(its largest magnitude, where that exceeds 1: the tiny models' logits
reach about 30, and two fp32 sum orders part by about 1e-7 of the scale
in each layer); a bf16 cache leaf (k, v) is the bf16 rounding of fp32
values that part so, so a few of its elements may round the other way:
at most max(2, 1/1,000 of the leaf) outside the bar, each within one
bf16 ulp.
"""

import contextlib
import dataclasses
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
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.nn import module, transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
ARCHS = ("qwen2.5-3b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
         "whisper-tiny")
MOE_ARCH = "qwen2-moe-a2.7b"
#: the config with a recurrent state (an RG-LRU's h and conv), whose ticks
#: the reference runs again from the port's cache
RECURRENT_ARCH = "recurrentgemma-9b"
BATCH, SEQ, MAX_LEN, STEPS = 4, 16, 16, 4
#: the overflow tick: 8 lanes, capacity max(1, int(8 x 2 / 6 x 0.5)) = 1
TICK_BATCH, TICK_CF = 8, 0.5


def _specs(cfg):
    return encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        transformer.model_specs(cfg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _weights(cfg, seed) -> dict:
    """The reference's ``init_tree`` rule, drawn with numpy: {path:
    array}."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale if spec.scale is not None else spec.fan_in() ** -0.5
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return _flat(module.map_specs(draw, _specs(cfg)))


def _nest(flat: dict, cfg) -> dict:
    def fill(t, prefix):
        if isinstance(t, dict):
            return {k: fill(t[k], f"{prefix}{k}/") for k in t}
        return flat[prefix[:-1]]
    return fill(_specs(cfg), "")


def _group(arrays, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _cfg(arch):
    return registry.get_tiny(arch).replace(activation_dtype="float32")


def _inputs(path: pathlib.Path) -> dict:
    rng = np.random.default_rng(7)
    arrays = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        arrays.update({f"{arch}/w/{k}": v
                       for k, v in _weights(cfg, i).items()})
        arrays[f"{arch}/tokens"] = rng.integers(
            0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
        for t in range(STEPS):
            arrays[f"{arch}/tok{t}"] = rng.integers(
                0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)
        if cfg.is_encoder_decoder:
            shp = (BATCH, cfg.encoder_len, cfg.d_model)
            arrays[f"{arch}/frames"] = rng.standard_normal(shp).astype(
                np.float32)
            arrays[f"{arch}/enc"] = rng.standard_normal(shp).astype(
                np.float32)
    for t in range(STEPS):
        # each lane at its own position; lane 3 passes the window of 8
        arrays[f"pos{t}"] = (np.arange(BATCH) * 3 + t).astype(np.int32)
    cfg = _cfg(MOE_ARCH)
    arrays["tick/tokens"] = rng.integers(
        0, cfg.vocab_size, (TICK_BATCH, 1)).astype(np.int32)
    arrays["tick/pos"] = np.zeros(TICK_BATCH, np.int32)
    np.savez(path, **arrays)
    return arrays


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 8 host devices
# ---------------------------------------------------------------------------

REFERENCE = r"""
import json, os, sys, time
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as dr, shardings as sh, steps
from repro.models import encdec
from repro.nn import attention, transformer

inp, out_path, meta = sys.argv[1:4]
arrays = dict(np.load(inp))
meta = json.loads(meta)
devs = jax.devices()     # 512: importing the dry-run asks for them
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=devs[:4],
                     axis_types=(AxisType.Auto,) * 2)
B, S, L = meta["batch"], meta["seq"], meta["max_len"]


def nest(prefix, cfg):
    specs = encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        transformer.model_specs(cfg)

    def fill(t, path):
        if isinstance(t, dict):
            return {k: fill(t[k], path + k + "/") for k in t}
        return jnp.asarray(arrays[prefix + "/" + path[:-1]])
    return fill(specs, "")


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        o = {}
        for k in sorted(tree):
            o.update(flat(tree[k], prefix + k + "/"))
        return o
    return {prefix[:-1]: np.asarray(tree)}


def pinned(cfg, b):
    rules = sh.rules_for(cfg)
    entry = sh.prune_spec((b,), rules.spec(("batch",), mesh), mesh)[0]
    if entry is None:
        return cfg
    return cfg.replace(batch_mesh_axes=(entry,) if isinstance(entry, str)
                       else tuple(entry))


def in_shardings(cfg, shape):
    rules = sh.rules_for(cfg)
    return {k: sh.sharding_for(tuple(v.shape), registry.input_axes(
        cfg, shape)[k], mesh, rules)
        for k, v in registry.input_specs(cfg, shape).items()}


out = {}
for arch in meta["archs"]:
    cfg = pinned(registry.get_tiny(arch).replace(activation_dtype="float32"),
                 B)
    rules = sh.rules_for(cfg)
    _, p_sh = sh.model_param_shardings(cfg, mesh)
    with jax.set_mesh(mesh):
        params = jax.device_put(nest(arch + "/w", cfg), p_sh)
        pre = ShapeConfig("p", S, B, "prefill")
        batch = {"tokens": jnp.asarray(arrays[arch + "/tokens"])}
        if cfg.is_encoder_decoder:
            batch["frames"] = jnp.asarray(arrays[arch + "/frames"])
        vocab_sh = sh.sharding_for((B, cfg.vocab_size), ("batch", "vocab"),
                                   mesh, rules)
        f = jax.jit(steps.make_prefill(cfg),
                    in_shardings=(p_sh, in_shardings(cfg, pre)),
                    out_shardings=vocab_sh)
        out[arch + "/prefill"] = np.asarray(f(params, batch))
        dec = ShapeConfig("d", L, B, "decode")
        _, c_sh = dr._cache_abstract_and_shardings(cfg, dec, mesh, rules)
        if cfg.is_encoder_decoder:
            cache = encdec.init_cache(cfg, B, L, enc=jnp.asarray(
                arrays[arch + "/enc"]))
        else:
            cache = transformer.init_cache(cfg, B, L)
        cache = jax.device_put(cache, c_sh)
        tok_sh = sh.sharding_for((B,), ("batch",), mesh, rules)
        step = jax.jit(steps.make_serve_step(cfg),
                       in_shardings=(p_sh, c_sh, in_shardings(cfg, dec)),
                       out_shardings=(tok_sh, c_sh), donate_argnums=(1,))
        for t in range(meta["steps"]):
            tok, cache = step(params, cache, {
                "tokens": jnp.asarray(arrays[f"{arch}/tok{t}"]),
                "pos": jnp.asarray(arrays[f"pos{t}"])})
            out[f"{arch}/tok{t}"] = np.asarray(tok)
        for k, v in flat(cache).items():
            out[f"{arch}/cache/{k}"] = v.astype(np.float64)
        if arch == meta["recurrent_arch"]:
            rerun = (cfg, params, p_sh, c_sh, tok_sh, dec, cache)

# the MoE overflow tick: its tokens and its logits
arch = meta["moe_arch"]
b = meta["tick_batch"]
cfg = pinned(registry.get_tiny(arch).replace(
    activation_dtype="float32", capacity_factor=meta["tick_cf"]), b)
rules = sh.rules_for(cfg)
_, p_sh = sh.model_param_shardings(cfg, mesh)
dec = ShapeConfig("d", L, b, "decode")
_, c_sh = dr._cache_abstract_and_shardings(cfg, dec, mesh, rules)
with jax.set_mesh(mesh):
    params = jax.device_put(nest(arch + "/w", cfg), p_sh)
    cache = jax.device_put(transformer.init_cache(cfg, b, L), c_sh)
    batch = {"tokens": jnp.asarray(arrays["tick/tokens"]),
             "pos": jnp.asarray(arrays["tick/pos"])}

    def tick(p, c, f):
        logits, c = transformer.decode_step(cfg, p, f["tokens"], c, f["pos"])
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), logits

    row_sh = sh.sharding_for((b,), ("batch",), mesh, rules)
    tok, logits = jax.jit(tick, in_shardings=(
        p_sh, c_sh, in_shardings(cfg, dec)), out_shardings=(
        row_sh, sh.sharding_for((b, cfg.vocab_size), ("batch", "vocab"),
                                mesh, rules)))(params, cache, batch)
    out["tick/tokens"], out["tick/logits"] = np.asarray(tok), \
        np.asarray(logits)

# the recurrent config's steps again, each from the port's cache: its K/V
# entries and positions after the step (the reference's writes of K and V
# left out, so it attends to the port's bf16 values, whichever way they
# rounded), its recurrent state before it, and the port's bf16 attention
# output in place of its own (kept: the reference's own, from that
# state); the state each step writes is kept.  It waits for the port's
# results (written when its 4 processes end)
files = [os.path.join(meta["port_dir"], f"rank{r}.npz") for r in range(4)]
deadline = time.time() + 500
while not all(os.path.exists(f) for f in files):
    if time.time() > deadline:
        raise SystemExit("the port's ranks wrote no results")
    time.sleep(0.2)
ranks = [dict(np.load(f)) for f in files]
arch = meta["recurrent_arch"]
cfg, params, p_sh, c_sh, tok_sh, dec, cache = rerun
write_at = attention._write_at


def keep_kv(cache_arr, val, slot):
    if jnp.issubdtype(cache_arr.dtype, jnp.floating):
        return cache_arr
    return write_at(cache_arr, val, slot)


def like(tree, leaves, path=""):
    if isinstance(tree, dict):
        return {k: like(tree[k], leaves, path + k + "/") for k in tree}
    return leaves[path[:-1]]


def port_whole(key, shape):
    a = np.zeros(shape, np.float64)
    for r in ranks:
        a[tuple(slice(lo, hi) for lo, hi in r[key + "_block"])] = r[key]
    return a


full_attention, seen = attention.full_attention, []


def attend(port_y):
    def run(q, k, v, **kw):
        y = full_attention(q, k, v, **kw)
        jax.debug.callback(lambda a: seen.append(np.asarray(a, np.float64)),
                           y)
        return jnp.asarray(port_y).astype(y.dtype)
    return run


attention._write_at = keep_kv
start = flat(transformer.init_cache(cfg, B, L))
for t in range(meta["steps"]):
    # its one attention layer: (B, 1, heads, head_dim)
    attention.full_attention = attend(port_whole(
        f"{arch}/attn{t}", (B, 1, cfg.n_heads, cfg.head_dim)))
    step = jax.jit(steps.make_serve_step(cfg),
                   in_shardings=(p_sh, c_sh, in_shardings(cfg, dec)),
                   out_shardings=(tok_sh, c_sh))
    whole = {}
    for leaf, was in flat(cache).items():
        before = leaf.split("/")[-1] not in ("k", "v", "kpos")
        if before and t == 0:
            whole[leaf] = jnp.asarray(start[leaf].astype(was.dtype))
            continue
        at = f"cache_after{t - 1}" if before else \
            "cache" if t == meta["steps"] - 1 else f"cache_after{t}"
        a = np.zeros(was.shape, np.float64)
        for r in ranks:
            a[tuple(slice(lo, hi) for lo, hi in
                    r[f"{arch}/cache_block/{leaf}"])] = \
                r[f"{arch}/{at}/{leaf}"]
        whole[leaf] = jnp.asarray(a.astype(was.dtype))
    with jax.set_mesh(mesh):
        _, res = step(params, jax.device_put(like(cache, whole), c_sh), {
            "tokens": jnp.asarray(arrays[f"{arch}/tok{t}"]),
            "pos": jnp.asarray(arrays[f"pos{t}"])})
    jax.effects_barrier()
    assert len(seen) == t + 1, len(seen)
    out[f"{arch}/same_attn{t}"] = seen[t]
    for leaf, v in flat(res).items():
        if leaf.split("/")[-1] in ("h", "conv"):
            out[f"{arch}/same_state{t}/{leaf}"] = v.astype(np.float64)
attention._write_at = write_at
attention.full_attention = full_attention
np.savez(out_path, **out)
print("REFERENCE DONE")
"""


def _reference(inputs: pathlib.Path, out: pathlib.Path) -> subprocess.Popen:
    """The reference's programs, then the recurrent config's ticks again
    from the port's caches, which it waits for in ``out``'s folder."""
    meta = {"archs": ARCHS, "moe_arch": MOE_ARCH, "batch": BATCH,
            "seq": SEQ, "max_len": MAX_LEN, "steps": STEPS,
            "tick_batch": TICK_BATCH, "tick_cf": TICK_CF,
            "recurrent_arch": RECURRENT_ARCH, "port_dir": str(out.parent)}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(out),
         json.dumps(meta)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# the port, in 4 spawned gloo processes
# ---------------------------------------------------------------------------

def _worker(rank: int, world: int, port: int, inputs: str, out_dir: str):
    """One rank of the 2 x 2 mesh: its rows of every result into
    ``out_dir/rank<r>.npz``."""
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = _rank_checks(np.load(inputs))
    finally:
        dist.destroy_process_group()
    # whole or not at all: the reference reads it once it exists
    tmp = pathlib.Path(out_dir) / f"rank{rank}.part.npz"
    np.savez(tmp, **res)
    os.replace(tmp, pathlib.Path(out_dir) / f"rank{rank}.npz")


def _rank_checks(arrays) -> dict:
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps

    mesh = mesh_lib.make_test_mesh((2, 2), ("data", "model"), "cpu")
    res: dict = {"coord": np.array(mesh.coordinate())}
    for arch in ARCHS:
        cfg = _cfg(arch)
        _, p_sh = sh.model_param_shardings(cfg, mesh)
        params = sh.shard_tree(module.params_from_numpy(_nest(
            _group(arrays, arch + "/w"), cfg)), p_sh)
        batch = {"tokens": arrays[f"{arch}/tokens"]}
        if cfg.is_encoder_decoder:
            batch["frames"] = arrays[f"{arch}/frames"]
        logits = steps.make_prefill(cfg)(params, batch)
        res[f"{arch}/prefill"] = logits.to_local().numpy()
        res[f"{arch}/prefill_layout"] = np.array(list(logits.shape) + [
            logits.placements == (Shard(0), Replicate())])
        if cfg.is_encoder_decoder:
            cache = encdec.init_cache(cfg, BATCH, MAX_LEN, enc=torch.tensor(
                arrays[f"{arch}/enc"]))
        else:
            cache = transformer.init_cache(cfg, BATCH, MAX_LEN)
        cache = sh.shard_tree(cache, sh.cache_shardings(cfg, BATCH, MAX_LEN,
                                                        mesh))
        step = steps.make_serve_step(cfg)
        for t in range(STEPS):
            with _attention_outputs(arch == RECURRENT_ARCH) as ys:
                tok, cache = step(params, cache, {
                    "tokens": arrays[f"{arch}/tok{t}"],
                    "pos": arrays[f"pos{t}"]})
            res[f"{arch}/tok{t}"] = tok.to_local().numpy()
            if arch != RECURRENT_ARCH:
                continue
            # its one attention layer's output: this rank's rows and heads
            (y,) = ys
            d, m = mesh.coordinate()
            h = y.shape[2]
            res[f"{arch}/attn{t}"] = y.to(torch.float64).numpy()
            res[f"{arch}/attn{t}_block"] = np.array([
                [d * len(y), (d + 1) * len(y)], [0, 1], [m * h, (m + 1) * h],
                [0, y.shape[3]]])
            if t + 1 < STEPS:
                for k, v in _flat(cache).items():
                    res[f"{arch}/cache_after{t}/{k}"] = \
                        sh.local(v).to(torch.float64).numpy()
        for k, v in _flat(cache).items():
            res[f"{arch}/cache/{k}"] = sh.local(v).to(torch.float64).numpy()
            res[f"{arch}/cache_block/{k}"] = np.array([
                [b.start, b.stop] for b in mesh.block(sh.sharding_of(v, mesh),
                                                      v.shape)])
    res.update(_overflow_tick(mesh, arrays))
    return res


@contextlib.contextmanager
def _attention_outputs(on: bool):
    """The outputs of ``nn.attention.full_attention`` inside, in order,
    where ``on``."""
    from repro_torch.nn import attention
    ys, full = [], attention.full_attention

    def record(*a, **kw):
        y = full(*a, **kw)
        ys.append(y.detach().clone())
        return y
    if on:
        attention.full_attention = record
    try:
        yield ys
    finally:
        attention.full_attention = full


def _overflow_tick(mesh, arrays) -> dict:
    """The MoE tick at TICK_BATCH lanes and TICK_CF, and the assignments
    each rank's routing drops that counting its own lanes alone would
    keep: ``nn.moe._plan`` run a second time with the counts not
    exchanged."""
    from repro_torch.launch import steps
    from repro_torch.nn import moe as moe_lib
    cfg = _cfg(MOE_ARCH).replace(capacity_factor=TICK_CF)
    _, p_sh = sh.model_param_shardings(cfg, mesh)
    params = sh.shard_tree(module.params_from_numpy(_nest(
        _group(arrays, MOE_ARCH + "/w"), cfg)), p_sh)
    cache = sh.shard_tree(transformer.init_cache(cfg, TICK_BATCH, MAX_LEN),
                          sh.cache_shardings(cfg, TICK_BATCH, MAX_LEN, mesh))
    plan, dropped = moe_lib._plan, []

    def probe(*a, shard=None, **kw):
        got = plan(*a, shard=shard, **kw)
        alone = plan(*a, shard=dataclasses.replace(
            shard, reduce=lambda t: t), **kw)
        dropped.append(float((alone[0].keep - got[0].keep).clamp(
            min=0).sum()))
        return got
    step = steps.make_serve_step(cfg)
    moe_lib._plan = probe
    try:
        tok, _ = step(params, cache, {"tokens": arrays["tick/tokens"],
                                      "pos": arrays["tick/pos"]})
    finally:
        moe_lib._plan = plan
    return {"tick/tokens": tok.to_local().numpy(),
            "tick/logits": step.logits().to_local().numpy(),
            "tick/dropped_across": np.array(sum(dropped)),
            "tick/moe_calls": np.array(len(dropped))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, each rank's results, the inputs): the
    reference's subprocess and the 4-rank spawn at once."""
    pytest.importorskip("jax")
    import torch.multiprocessing as mp
    work = tmp_path_factory.mktemp("serve_mesh")
    inputs = work / "inputs.npz"
    arrays = _inputs(inputs)
    proc = _reference(inputs, work / "reference.npz")
    try:
        mp.start_processes(_worker, args=(4, _free_port(), str(inputs),
                                          str(work)),
                           nprocs=4, start_method="spawn")
        _, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    ref = dict(np.load(work / "reference.npz"))
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]
    return types.SimpleNamespace(ref=ref, ranks=ranks, arrays=arrays)


def _hold(got, want, what: str = "", bf16: bool = False) -> None:
    """``got`` against ``want`` at the module docstring's bar."""
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


def _off(got, want) -> np.ndarray:
    """Where ``got`` lies outside the bar of :func:`_hold` (a bf16 value
    that rounded the other way does: it differs by an ulp)."""
    atol = ATOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    return np.abs(got - want) > atol + RTOL * np.abs(want)


def _hold_rows(got, want, what: str) -> np.ndarray:
    """A bf16 attention output (B, 1, heads, head_dim) against ``want``:
    at most one (lane, head) row outside :func:`_hold`'s bar, each of its
    elements within one bf16 ulp of the row's largest magnitude (a
    probability that rounds the other way moves its whole row, by that
    ulp times the values); whether each lane has such a row."""
    off = _off(got, want).any(axis=(1, 3))                  # (B, heads)
    assert off.sum() <= 1, (what, off.sum())
    scale = np.abs(want).max(axis=3, keepdims=True)
    assert (np.abs(got - want) <= 2.0 ** -7 * scale).all(), what
    return off.any(axis=1)


def sh_mesh():
    """The 2 x 2 (data, model) mesh's shape, for the plans."""
    from repro_torch.launch.mesh import Mesh
    return Mesh({"data": 2, "model": 2})


def _rows(r: dict, n: int) -> slice:
    """The rows of a batch of ``n`` that rank ``r``'s data index holds."""
    d = int(r["coord"][0])
    return slice(d * n // 2, (d + 1) * n // 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_reference(runs, arch):
    """Each rank's rows of the (B, vocab) logits, a DTensor split over
    ``data`` and whole over ``model``."""
    want = runs.ref[f"{arch}/prefill"]
    cfg = _cfg(arch)
    for r in runs.ranks:
        assert list(r[f"{arch}/prefill_layout"][:2]) == [BATCH,
                                                         cfg.vocab_size]
        assert bool(r[f"{arch}/prefill_layout"][2])
        _hold(r[f"{arch}/prefill"], want[_rows(r, BATCH)], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_reference(runs, arch):
    """4 steps from a zero cache: every step's tokens equal the
    reference's, and after them each rank's cache block is that block of
    every leaf of the reference's cache: its rows, whole over ``model``
    under the gather plan, its KV heads or RG-LRU channels of them under
    the split plan (qwen2.5-3b's head-width columns).

    The K/V entries and the attention's probabilities and output are
    bf16, and a value within noise of a rounding boundary may round the
    other way (:func:`_hold`); a lane's later layers then read other
    values.  So recurrentgemma's attention output of every step is held
    against the reference's step from the port's cache (:func:`_hold_rows`),
    and
    its recurrent state (``h``, ``conv``) after every step at the bar
    against the state that step writes from the port's cache and the
    port's attention output, every lane.  Every leaf of every lane is held
    against the reference's own cache but, under the split plan, the
    recurrent state of a lane whose K/V entries or attention output held
    the other rounding (recurrentgemma's lane 1: at step 2 a V entry is
    one ulp off and a probability of its head 3 rounds the other way, its
    remainder layers' state then 1.7e-3 off the reference's own).  At
    most one lane in two."""
    ref = runs.ref
    leaves = sorted(k[len(arch) + 7:] for k in ref
                    if k.startswith(f"{arch}/cache/"))
    assert len(leaves) >= 2
    split = sh.model_split(_cfg(arch), sh_mesh())
    rounded = 0
    for r in runs.ranks:
        rows = _rows(r, BATCH)
        for t in range(STEPS):
            np.testing.assert_array_equal(r[f"{arch}/tok{t}"],
                                          ref[f"{arch}/tok{t}"][rows])
        got_leaves = sorted(k[len(arch) + 7:] for k in r
                            if k.startswith(f"{arch}/cache/"))
        assert got_leaves == leaves
        blocks, other = {}, np.zeros(rows.stop - rows.start, bool)
        for t in range(STEPS * (arch == RECURRENT_ARCH)):
            block = tuple(slice(a, b) for a, b in r[f"{arch}/attn{t}_block"])
            assert block[0] == rows, block
            got, want = r[f"{arch}/attn{t}"], \
                ref[f"{arch}/same_attn{t}"][block]
            other |= _hold_rows(got, want, f"attention output, step {t}")
        for leaf in leaves:
            block = tuple(slice(a, b) for a, b in
                          r[f"{arch}/cache_block/{leaf}"])
            # stacked leaves carry the layers in front of the batch
            at = int(leaf.split("/")[0] in ("blocks", "self"))
            assert block[at] == rows, (leaf, block)
            if split is None:
                assert all(b == slice(0, n) for d, (b, n) in enumerate(zip(
                    block, ref[f"{arch}/cache/{leaf}"].shape)) if d != at)
            blocks[leaf] = (block, at)
            if leaf.split("/")[-1] in ("k", "v"):
                got = r[f"{arch}/cache/{leaf}"]
                want = ref[f"{arch}/cache/{leaf}"][block]
                _hold(got, want, leaf, bf16=True)
                other |= _off(got, want).any(axis=tuple(
                    d for d in range(got.ndim) if d != at))
        rounded += int(other.sum())
        for leaf, (block, at) in blocks.items():
            name = leaf.split("/")[-1]
            if name in ("k", "v"):
                continue
            lanes = (slice(None),) * (at + 1)
            if name in ("h", "conv"):
                for t in range(STEPS):
                    after = "cache" if t == STEPS - 1 else f"cache_after{t}"
                    _hold(r[f"{arch}/{after}/{leaf}"],
                          ref[f"{arch}/same_state{t}/{leaf}"][block],
                          f"{leaf} step {t}, from the port's cache")
                if split is not None:
                    lanes = (slice(None),) * at + (~other,)
            _hold(r[f"{arch}/cache/{leaf}"][lanes],
                  ref[f"{arch}/cache/{leaf}"][block][lanes], leaf)
    # each lane is counted by both ranks of its model group
    assert rounded <= BATCH, rounded


def test_decode_steps_write_the_window_and_the_recurrent_state(runs):
    """The decode cases reach what they claim: recurrentgemma's window
    rolls (a lane's ``kpos`` holds positions past the window's 8 slots)
    and its recurrent state and conv leaves moved; whisper's enc leaf is
    the drawn encoder output."""
    ref = runs.ref
    kpos = ref["recurrentgemma-9b/cache/blocks/2/kpos"]
    assert kpos.max() >= 8 and kpos.shape[-1] == 8
    for leaf in ("blocks/0/h", "blocks/0/conv", "extra/0/h"):
        assert np.abs(ref[f"recurrentgemma-9b/cache/{leaf}"]).max() > 0
    np.testing.assert_allclose(ref["whisper-tiny/cache/enc"],
                               runs.arrays["whisper-tiny/enc"])


def test_moe_tick_overflow_across_ranks_matches_reference(runs):
    """Capacity 1 per expert over 8 lanes: the tokens equal the
    reference's and the logits hold at the bar, and data rank 1 drops
    assignments that its own lanes alone would keep: the whole batch's
    counts decided them, as the reference's sort over every lane does
    (ROADMAP.md R7)."""
    for r in runs.ranks:
        rows = _rows(r, TICK_BATCH)
        np.testing.assert_array_equal(r["tick/tokens"],
                                      runs.ref["tick/tokens"][rows])
        _hold(r["tick/logits"], runs.ref["tick/logits"][rows], "logits")
        assert int(r["tick/moe_calls"]) == _cfg(MOE_ARCH).n_layers
        if int(r["coord"][0]) == 0:
            assert float(r["tick/dropped_across"]) == 0.0
        else:
            assert float(r["tick/dropped_across"]) > 0.0
