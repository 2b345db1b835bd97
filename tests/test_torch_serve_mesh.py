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
  equal, and each rank's cache block, which is its rows of every leaf
  whole, at the bar against those rows of the reference's cache;
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
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as dr, shardings as sh, steps
from repro.models import encdec
from repro.nn import transformer

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
np.savez(out_path, **out)
print("REFERENCE DONE")
"""


def _reference(inputs: pathlib.Path, out: pathlib.Path) -> subprocess.Popen:
    meta = {"archs": ARCHS, "moe_arch": MOE_ARCH, "batch": BATCH,
            "seq": SEQ, "max_len": MAX_LEN, "steps": STEPS,
            "tick_batch": TICK_BATCH, "tick_cf": TICK_CF}
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
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)


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
            tok, cache = step(params, cache, {
                "tokens": arrays[f"{arch}/tok{t}"],
                "pos": arrays[f"pos{t}"]})
            res[f"{arch}/tok{t}"] = tok.to_local().numpy()
        for k, v in _flat(cache).items():
            res[f"{arch}/cache/{k}"] = sh.local(v).to(torch.float64).numpy()
    res.update(_overflow_tick(mesh, arrays))
    return res


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
    reference's, and after them each rank's cache block is its rows of
    every leaf of the reference's cache, whole over ``model``."""
    ref = runs.ref
    leaves = sorted(k[len(arch) + 7:] for k in ref
                    if k.startswith(f"{arch}/cache/"))
    assert len(leaves) >= 2
    for r in runs.ranks:
        rows = _rows(r, BATCH)
        for t in range(STEPS):
            np.testing.assert_array_equal(r[f"{arch}/tok{t}"],
                                          ref[f"{arch}/tok{t}"][rows])
        got_leaves = sorted(k[len(arch) + 7:] for k in r
                            if k.startswith(f"{arch}/cache/"))
        assert got_leaves == leaves
        for leaf in leaves:
            want = ref[f"{arch}/cache/{leaf}"]
            # stacked leaves carry the layers in front of the batch
            want = want[:, rows] if leaf.split("/")[0] in (
                "blocks", "self") else want[rows]
            _hold(r[f"{arch}/cache/{leaf}"], want, leaf,
                  bf16=leaf.split("/")[-1] in ("k", "v"))


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
