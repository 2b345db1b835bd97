"""The RG-LRU hybrid (RecurrentGemma) in the port, held against the
reference package: the block (``nn/rglru.py``), the models built of it
(``recurrentgemma-9b``'s ``tiny()`` and ``tests/test_nn_blocks.py``'s
``rglru-hybrid`` config), their caches, the engine and the launcher.

Both packages get the same numpy inputs (from a seed) and the reference's
``init_tree(specs, PRNGKey)`` weights as numpy.  Tolerances:

* the block at fp32: within 1e-5 of the output's scale (max |y|).  The
  port scans by recursive doubling where the reference runs
  ``jax.lax.associative_scan``: the same products in another tree;
* the model at fp32: logits within 1e-4 of their scale, greedy tokens
  equal, the engine's token lists equal the reference engine's;
* the model at bf16: within max(2%, 2 x the reference's own bf16 error)
  of the scale from the reference's fp32 logits, the LM's bar;
* the cache's dtypes after a step equal the reference's (ROADMAP.md R8);
* on the card: the model within 1e-3 of the scale of its CPU run at fp32
  (cuBLAS sums in another order), and a replayed decode step equal to the
  eager one value for value at bf16, every cache leaf included.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.graphs import GraphRunner  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import module, rglru, transformer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

BLOCK_SCALE_TOL = 1e-5
FP32_SCALE_TOL = 1e-4
BF16_SCALE_TOL = 0.02
CARD_SCALE_TOL = 1e-3
ARCH = "recurrentgemma-9b"

#: tests/test_nn_blocks.py's hybrid config, as keyword arguments
HYBRID = dict(name="t", family="hybrid", n_layers=5, d_model=32, n_heads=4,
              n_kv_heads=1, d_ff=64, vocab_size=64, lru_width=32,
              attn_pattern=("rglru", "rglru", "local"), window=8,
              attn_block_size=32)
W, H = 32, 4                         # the block's width and heads


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (they import JAX, which the card's
    machine does not have: the ``gpu`` tests below do without them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import lm as ref_lm
    from repro.nn import module as ref_module
    from repro.nn import rglru as ref_rglru
    from repro.nn import transformer as ref_tr
    from repro.serving.engine import ServingEngine as RefEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=ref_registry,
                                 Config=RefConfig, lm=ref_lm,
                                 module=ref_module, rglru=ref_rglru,
                                 tr=ref_tr, Engine=RefEngine)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_config(name: str) -> ModelConfig:
    if name == "rglru-hybrid":
        return ModelConfig(**HYBRID)
    return registry.get_tiny(name.split(":")[0])


def _model(ref, name, dtype="float32"):
    """(reference config, port config, reference params, port params)."""
    rc = ref.Config(**HYBRID) if name == "rglru-hybrid" else \
        ref.registry.get_tiny(name.split(":")[0])
    rc = rc.replace(activation_dtype=dtype)
    pc = _port_config(name).replace(activation_dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = ref.module.init_tree(ref.tr.model_specs(rc), ref.jax.random.key(0))
    return rc, pc, rp, module.params_from_numpy(_np(rp))


@pytest.fixture(scope="module")
def block(ref):
    """The block's weights (the reference's init, gates and biases drawn
    non-zero) in both packages."""
    specs = ref.rglru.rglru_block_specs(W, W, H, 4)
    p = _np(ref.module.init_tree(specs, ref.jax.random.key(3)))
    rng = np.random.default_rng(3)
    for name in ("conv", "gate_a", "gate_x"):
        p[name]["bias"] = rng.normal(0, 0.3, W).astype(np.float32)
    p["lamb"] = rng.uniform(-1, 2, W).astype(np.float32)
    return (ref.jax.tree_util.tree_map(ref.jnp.asarray, p),
            module.params_from_numpy(p))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_block_prefill_matches_reference(ref, block, s):
    rp, pp = block
    x = _rand(s, 2, s, W)
    want, none = ref.rglru.rglru_block(rp, ref.jnp.asarray(x), n_heads=H)
    got, cache = rglru.rglru_block(pp, _t(x), n_heads=H)
    assert none is None and cache is None
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _scale_err(got, want) <= BLOCK_SCALE_TOL


def test_rglru_scan_with_h0_matches_reference(ref, block):
    rp, pp = block
    x, h0 = _rand(1, 2, 37, W), _rand(2, 2, W)
    want, want_last = ref.rglru.rglru_scan(rp, ref.jnp.asarray(x), n_heads=H,
                                           h0=ref.jnp.asarray(h0))
    got, last = rglru.rglru_scan(pp, _t(x), n_heads=H, h0=_t(h0))
    assert last.dtype == torch.float32
    assert _scale_err(got, want) <= BLOCK_SCALE_TOL
    assert _scale_err(last, want_last) <= BLOCK_SCALE_TOL


def test_rglru_step_and_conv_state_match_reference(ref, block):
    """Three decode steps of the block from a non-zero state: the output,
    the new ``h`` and the conv's trailing state, written into the port's
    cache in place."""
    rp, pp = block
    h, conv = _rand(1, 2, W), _rand(2, 2, 3, W)
    ref_cache = {"h": ref.jnp.asarray(h), "conv": ref.jnp.asarray(conv)}
    cache = {"h": _t(h).clone(), "conv": _t(conv).clone()}
    leaves = dict(cache)
    for step in range(3):
        x = _rand(10 + step, 2, 1, W)
        want, ref_cache = ref.rglru.rglru_block(
            rp, ref.jnp.asarray(x), n_heads=H, cache=ref_cache)
        got, out = rglru.rglru_block(pp, _t(x), n_heads=H, cache=cache)
        assert out is cache and all(cache[k] is leaves[k] for k in cache)
        assert _scale_err(got, want) <= BLOCK_SCALE_TOL
        for k in ("h", "conv"):
            assert _scale_err(cache[k], ref_cache[k]) <= BLOCK_SCALE_TOL
    # the conv alone, from a state
    x = _rand(20, 2, 5, W)
    want, want_state = ref.rglru._causal_conv(rp["conv"], ref.jnp.asarray(x),
                                              ref.jnp.asarray(conv))
    got, state = rglru._causal_conv(pp["conv"], _t(x), _t(conv))
    assert _scale_err(got, want) <= BLOCK_SCALE_TOL
    np.testing.assert_array_equal(state.numpy(), np.asarray(want_state))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_model_logits_and_greedy_tokens_match_reference(ref):
    """fp32: forward, prefill and eight decode steps within 1e-4 of the
    scale, their greedy tokens equal; bf16: the forward within the LM's
    bar.  (``tests/test_torch_lm.py`` holds ``recurrentgemma-9b``'s tiny
    config so, with every other ported architecture.)"""
    rc, pc, rp, pp = _model(ref, "rglru-hybrid")
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 40))
    fwd = ref.jax.jit(lambda t: ref.tr.forward(rc, rp, t)[0])
    want = np.asarray(fwd(ref.jnp.asarray(toks)))
    got = transformer.forward(pc, pp, _t(toks))[0]
    got_pre = lm.prefill(pc, pp, _t(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    step = ref.jax.jit(lambda t, c, p: ref.tr.decode_step(rc, rp, t, c, p))
    ref_cache, cache = ref.tr.init_cache(rc, 2, 12), transformer.init_cache(
        pc, 2, 12)
    for t in range(8):
        wl, ref_cache = step(ref.jnp.asarray(toks[:, t:t + 1]), ref_cache,
                             ref.jnp.full((2,), t, ref.jnp.int32))
        gl, cache = transformer.decode_step(pc, pp, _t(toks[:, t:t + 1]),
                                            cache, torch.full((2,), t))
        assert _scale_err(gl, wl) <= FP32_SCALE_TOL
        np.testing.assert_array_equal(gl.argmax(-1).numpy(),
                                      np.asarray(wl).argmax(-1))
    for g, w in ((got, want), (got_pre, want[:, -1])):
        assert _scale_err(g, w) <= FP32_SCALE_TOL
        np.testing.assert_array_equal(g.argmax(-1).numpy(), w.argmax(-1))

    rc16, pc16 = (c.replace(activation_dtype="bfloat16") for c in (rc, pc))
    ref16 = np.asarray(ref.jax.jit(lambda t: ref.tr.forward(rc16, rp, t)[0])(
        ref.jnp.asarray(toks)))
    got16 = transformer.forward(pc16, pp, _t(toks))[0]
    assert _scale_err(got16, want) <= max(BF16_SCALE_TOL,
                                          2 * _scale_err(ref16, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_dtypes_after_a_step_equal_reference(ref, dtype):
    """R8: the reference stores a stacked layer's conv state in bf16 and a
    remainder layer's in the activation dtype; the port allocates its cache
    so from the start, and a step keeps every leaf's dtype and shape."""
    rc, pc, rp, pp = _model(ref, f"{ARCH}:tiny", dtype)
    toks = np.ones((2, 1), np.int64)
    step = ref.jax.jit(lambda t, c, p: ref.tr.decode_step(rc, rp, t, c, p))
    _, ref_cache = step(ref.jnp.asarray(toks), ref.tr.init_cache(rc, 2, 8),
                        ref.jnp.zeros(2, ref.jnp.int32))
    cache = transformer.init_cache(pc, 2, 8)
    before = module.map_tree(lambda a: (a.dtype, a.shape), cache)
    transformer.decode_step(pc, pp, _t(toks), cache,
                            torch.zeros(2, dtype=torch.int64))
    assert module.map_tree(lambda a: (a.dtype, a.shape), cache) == before
    want = ref.jax.tree_util.tree_map(lambda a: (str(a.dtype), a.shape),
                                      ref_cache)
    got = module.map_tree(lambda a: (str(a.dtype).split(".")[1],
                                     tuple(a.shape)), cache)
    assert got == _np_tree(want)
    assert got["extra"]["0"]["conv"][0] == dtype
    assert got["blocks"]["0"]["conv"][0] == "bfloat16"


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree


def _spec_leaves(specs, prefix=""):
    """Shape, axes, init and scale of every leaf of a spec tree (either
    package's ``ParamSpec``), by path."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_spec_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), tuple(v.axes), v.init,
                               v.scale)
    return out


def test_spec_tree_count_and_flops_equal_reference(ref):
    for get, ref_get in ((registry.get_config, ref.registry.get_config),
                         (registry.get_tiny, ref.registry.get_tiny)):
        port = transformer.model_specs(get(ARCH))
        want = ref.tr.model_specs(ref_get(ARCH))
        assert _spec_leaves(port) == _spec_leaves(want)
        assert module.param_count(port) == ref.module.param_count(want)
        assert lm.model_flops_per_token(get(ARCH)) == \
            ref.lm.model_flops_per_token(ref_get(ARCH))
    full = registry.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.head_dim, full.window) == (
        38, 4096, 256, 2048)
    assert module.param_count(transformer.model_specs(full)) > 8.5e9


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

REQUESTS = [([5, 6, 7, 8], 6), ([9, 10], 5), ([11, 12, 13], 7), ([1], 4),
            ([2, 3, 4, 5, 6, 7, 8], 3), ([30, 31], 8)]


def test_engine_tokens_equal_reference_at_fp32(ref):
    """Six requests over three lanes at fp32, lanes refilled: the port's
    engine gives the reference engine's token lists."""
    rc, pc, rp, pp = _model(ref, f"{ARCH}:tiny")
    outs = []
    for eng in (ref.Engine(rc, rp, max_batch=3, max_len=32),
                ServingEngine(pc, pp, max_batch=3, max_len=32)):
        for prompt, n in REQUESTS:
            eng.submit(prompt, max_new_tokens=n)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
    assert outs[1] == outs[0]
    assert [len(outs[1][i]) for i in range(6)] == [n for _, n in REQUESTS]


def test_refilled_lane_gives_the_tokens_of_its_request_alone():
    """One lane serves a long request, then a short one: the short one's
    tokens equal those it gets alone in a fresh engine.  The long request
    leaves recurrent state behind, which only the lane's reset clears."""
    cfg = registry.get_tiny(ARCH).replace(activation_dtype="float32")
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(2))
    short = ([7, 8, 9], 6)
    alone = ServingEngine(cfg, params, max_batch=1, max_len=64)
    alone.submit(*short)
    want = alone.run_until_drained()[0].output

    eng = ServingEngine(cfg, params, max_batch=1, max_len=64)
    eng.submit(list(range(1, 20)), max_new_tokens=12)
    while not eng.finished:
        eng.tick()
    assert float(eng.cache["extra"]["0"]["h"].abs().max()) > 0
    eng.submit(*short)
    assert eng.run_until_drained()[1].output == want


def test_serve_cli_on_cpu(capsys):
    stats = serve.main(["--arch", ARCH, "--requests", "3", "--max-batch",
                        "2", "--new-tokens", "5", "--device", "cpu"])
    assert stats["requests"] == 3 and stats["generated_tokens"] == 15
    assert "[serve] recurrentgemma-tiny" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_model_on_card_matches_its_cpu_run(cuda):
    """The tiny model's forward (K5 for the local layer) and ten decode
    steps at fp32 on the card, against the same on the CPU."""
    cfg = registry.get_tiny(ARCH).replace(activation_dtype="float32")
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    on_card = module.map_tree(lambda a: a.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    want = transformer.forward(cfg, params, toks)[0]
    got = transformer.forward(cfg, on_card, toks.to(cuda))[0]
    assert _scale_err(got.cpu(), want.numpy()) <= CARD_SCALE_TOL
    caches = [transformer.init_cache(cfg, 2, 12),
              transformer.init_cache(cfg, 2, 12, cuda)]
    for t in range(10):
        want, _ = transformer.decode_step(cfg, params, toks[:, t:t + 1],
                                          caches[0], torch.full((2,), t))
        got, _ = transformer.decode_step(cfg, on_card,
                                         toks[:, t:t + 1].to(cuda),
                                         caches[1],
                                         torch.full((2,), t, device=cuda))
        assert _scale_err(got.cpu(), want.numpy()) <= CARD_SCALE_TOL


@pytest.mark.gpu
def test_replayed_decode_step_equals_eager_on_card(cuda):
    """The bf16 decode step captured into a CUDA graph: each replay writes
    the recurrent state and the KV cache in place, equal value for value
    to the eager step on a copy of the same cache."""
    cfg = registry.get_tiny(ARCH)
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator(device=cuda).manual_seed(0),
                              device=cuda)
    cache = transformer.init_cache(cfg, 3, 16, cuda)
    run = GraphRunner(lambda f: lm.serve_step(cfg, params, f["tokens"],
                                              cache, f["pos"])[0], cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for t in range(6):
        toks = torch.randint(0, cfg.vocab_size, (3, 1), generator=gen,
                             device=cuda)
        pos = torch.full((3,), t, device=cuda)
        if t == 0:
            run({"tokens": toks, "pos": pos})        # eager, then capture
            continue
        twin = module.map_tree(torch.clone, cache)
        want, _ = lm.serve_step(cfg, params, toks, twin, pos)
        got = run({"tokens": toks, "pos": pos})
        assert torch.equal(got, want)
        for a, b in zip(module.tree_leaves(cache), module.tree_leaves(twin)):
            assert torch.equal(a, b)
    assert len(run.replay_launches()) == 1
