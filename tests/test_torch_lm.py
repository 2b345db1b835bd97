"""The decoder LM's serving path in the port, held against the reference
package: configs, layers, rope, attention and its KV caches, the spec
tree, ``forward``, ``decode_step``, ``lm.prefill`` and ``lm.serve_step``.

Both packages get the same numpy inputs (from a seed) and the reference's
``init_tree(specs, PRNGKey)`` weights as numpy.  On the CPU the port's
prefill attention runs the flash kernel's plain version; the reference
runs its jnp paths (full, or blockwise above ``attn_block_size``).

Tolerances:

* layer functions at fp32, rtol 1e-5 / atol 1e-6: the same fp32
  arithmetic in another framework;
* attention (self, decode) at fp32, rtol 1e-5 / atol 1e-6 on outputs of
  scale ~1;
* the model at fp32: logits within 1e-4 of their scale (max |logit|),
  greedy tokens equal;
* the model at bf16: the port's logits within max(2%, 2 x the reference's
  own bf16 error) of the scale from the reference's fp32 logits.  bf16
  rounds at other places in the two packages: the port keeps the
  attention probabilities in fp32 (the flash kernel's contract) where the
  reference rounds them to bf16, and XLA on the CPU skips some bf16
  roundings (``xla_allow_excess_precision``).  On the local+softcap
  config bf16 alone moves the reference about 2% off its fp32 logits, so
  no bar of 2% between the two bf16 runs could hold there;
* the port's decode against its own forward: 1% of the logit scale, the
  reference's bar (``tests/test_nn_blocks.py``), with the same attention
  arithmetic on both sides (``test_decode_matches_forward``).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, ModelConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import attention, layers, module, rope  # noqa: E402
from repro_torch.nn import transformer  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FP32_SCALE_TOL = 1e-4
BF16_SCALE_TOL = 0.02
DECODE_SCALE_TOL = 0.01

#: tests/test_nn_blocks.py's dense configs, as keyword arguments
BLOCK_CONFIGS = {
    "dense-gqa": dict(
        name="t", family="dense", n_layers=3, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab_size=64, attn_pattern=("global",),
        attn_block_size=32),
    "local+softcap+postnorm": dict(
        name="t", family="dense", n_layers=4, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab_size=64,
        attn_pattern=("local", "global"), window=8, attn_softcap=20.0,
        final_softcap=30.0, post_norms=True, zero_centered_norm=True,
        attn_block_size=32),
}
#: the decoder-only architectures (whisper-tiny's encoder-decoder has its
#: own tests, tests/test_torch_encdec.py)
DECODERS = tuple(a for a in registry.ARCH_IDS
                 if not registry.get_config(a).is_encoder_decoder)
MODELS = list(BLOCK_CONFIGS) + [f"{a}:tiny" for a in DECODERS]


@pytest.fixture(scope="module")
def ref():
    """The reference package's LM modules (they import JAX, which the card's
    machine does not have: the ``gpu`` tests below do without them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.configs.base import ModelConfig as RefConfig
    from repro.models import lm as ref_lm
    from repro.nn import attention, layers
    from repro.nn import module as ref_module
    from repro.nn import rope as ref_rope
    from repro.nn import transformer as ref_tr
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=ref_registry, Config=RefConfig,
        lm=ref_lm, attn=attention, layers=layers, module=ref_module,
        rope=ref_rope, tr=ref_tr)


def _port_config(name: str) -> ModelConfig:
    if name in BLOCK_CONFIGS:
        return ModelConfig(**BLOCK_CONFIGS[name])
    return registry.get_tiny(name.split(":")[0])


def _configs(ref, name: str) -> tuple:
    """(the reference's config, the port's) of a model name."""
    if name in BLOCK_CONFIGS:
        return ref.Config(**BLOCK_CONFIGS[name]), _port_config(name)
    return ref.registry.get_tiny(name.split(":")[0]), _port_config(name)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_equal_reference(ref, arch):
    assert dataclasses.asdict(registry.get_config(arch)) == \
        dataclasses.asdict(ref.registry.get_config(arch))
    assert dataclasses.asdict(registry.get_tiny(arch)) == \
        dataclasses.asdict(ref.registry.get_tiny(arch))


def test_registry_names_what_is_not_ported(ref):
    assert set(registry.ARCH_IDS) | set(registry.NOT_PORTED) == \
        set(ref.registry.ARCH_IDS)
    ported = {"qwen2-moe-a2.7b", "mixtral-8x7b", "recurrentgemma-9b",
              "xlstm-1.3b", "whisper-tiny"}
    assert ported <= set(registry.ARCH_IDS)
    assert not ported & set(registry.NOT_PORTED)
    for arch in registry.NOT_PORTED:
        with pytest.raises(KeyError, match="item 8"):
            registry.get_config(arch)
        with pytest.raises(KeyError, match="item 8"):
            registry.get_tiny(arch)
    with pytest.raises(KeyError, match="unknown"):
        registry.get_config("gpt-5")
    assert registry.get_config("braggnn").name == "braggnn"
    assert registry.get_shape("decode_32k") == SHAPES["decode_32k"]
    assert list(registry.all_cells(include_skipped=True)) == [
        c for c in ref.registry.all_cells(include_skipped=True)
        if c[0] in registry.ARCH_IDS]


# ---------------------------------------------------------------------------
# nn.module: specs, stack, init on a device
# ---------------------------------------------------------------------------

def _spec_fields(spec):
    return (tuple(spec.shape), tuple(spec.axes), spec.init, spec.scale)


def _ref_leaves(specs, prefix=""):
    out = {}
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            out.update(_ref_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _spec_fields(v)
    return out


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_spec_trees_agree_leaf_for_leaf(ref, arch):
    """Each architecture's spec tree; the encoder-decoder's is
    ``models/encdec``'s in both packages, and has no decoder LM FLOPs."""
    from repro.models import encdec as ref_encdec

    from repro_torch.models import encdec
    for get, ref_get in ((registry.get_config, ref.registry.get_config),
                         (registry.get_tiny, ref.registry.get_tiny)):
        if arch in DECODERS:
            port = transformer.model_specs(get(arch))
            want = ref.tr.model_specs(ref_get(arch))
        else:
            port = encdec.model_specs(get(arch))
            want = ref_encdec.model_specs(ref_get(arch))
        assert _ref_leaves(port) == _ref_leaves(want)
        assert module.param_count(port) == ref.module.param_count(want)
        assert module.param_bytes(port) == ref.module.param_bytes(want)
    if arch in DECODERS:
        assert lm.model_flops_per_token(registry.get_config(arch)) == \
            ref.lm.model_flops_per_token(ref.registry.get_config(arch))


def test_qwen25_3b_size():
    specs = transformer.model_specs(registry.get_config("qwen2.5-3b"))
    assert module.param_count(specs) == 3_085_938_688
    assert module.param_bytes(specs) == 4 * 3_085_938_688
    cache = transformer.init_cache(registry.get_config("qwen2.5-3b"), 1, 1)
    # one token slot of Qwen2.5-3B's cache: 36 layers, k and v, 2 heads of
    # 128 bf16 values
    assert sum(t.numel() * t.element_size()
               for t in module.tree_leaves(cache)) == 36_864


def test_init_tree_stack_and_device():
    spec = {"w": module.ParamSpec((3, 4), ("a", "b")),
            "s": module.ParamSpec((4,), ("b",), init="ones")}
    st = module.stack(spec, 5)
    assert st["w"].shape == (5, 3, 4) and st["w"].axes == ("layers", "a",
                                                           "b")
    a = module.init_tree(st, torch.Generator().manual_seed(3))
    b = module.init_tree(st, torch.Generator().manual_seed(3), device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]) and b[k].device.type == "cpu"
    assert torch.equal(b["s"], torch.ones(5, 4))
    # std 1/sqrt(fan_in) over the stacked leaf's leading dims
    assert abs(float(b["w"].std()) - 1 / np.sqrt(15)) < 0.15


# ---------------------------------------------------------------------------
# layers, rope, masks, attention
# ---------------------------------------------------------------------------

def _layer_case(ref, name):
    """(reference result, port result) of one layer function at fp32."""
    x = _rand(0, 2, 5, 16)
    if name.startswith("rmsnorm") or name == "layernorm":
        p = {"scale": _rand(1, 16, scale=0.5), "bias": _rand(2, 16)}
        if name == "layernorm":
            return (ref.layers.layernorm(p, ref.jnp.asarray(x)),
                    layers.layernorm(module.params_from_numpy(p), _t(x)))
        zc = name.endswith("zero_centered")
        p = {"scale": p["scale"]}
        return (ref.layers.rmsnorm(p, ref.jnp.asarray(x), zero_centered=zc),
                layers.rmsnorm(module.params_from_numpy(p), _t(x),
                               zero_centered=zc))
    if name.startswith("dense"):
        p = {"kernel": _rand(1, 16, 24, scale=0.25)}
        if name.endswith("bias"):
            p["bias"] = _rand(2, 24)
        return (ref.layers.dense(p, ref.jnp.asarray(x)),
                layers.dense(module.params_from_numpy(p), _t(x)))
    if name in ("embed", "unembed"):
        p = {"table": _rand(1, 40, 16)}
        if name == "embed":
            ids = np.random.default_rng(2).integers(0, 40, (3, 7))
            return (ref.layers.embed(p, ref.jnp.asarray(ids),
                                     dtype=ref.jnp.float32),
                    layers.embed(module.params_from_numpy(p), _t(ids),
                                 dtype=torch.float32))
        return (ref.layers.unembed(p, ref.jnp.asarray(x)),
                layers.unembed(module.params_from_numpy(p), _t(x)))
    if name.startswith("mlp"):
        gated = not name.endswith("ungated")
        act = "gelu" if "gelu" in name else "silu"
        p = {"wi": _rand(1, 16, 32, scale=0.25),
             "wo": _rand(2, 32, 16, scale=0.2)}
        if gated:
            p["wg"] = _rand(3, 16, 32, scale=0.25)
        return (ref.layers.mlp(p, ref.jnp.asarray(x), act=act),
                layers.mlp(module.params_from_numpy(p), _t(x), act=act))
    if name == "softcap":
        y = _rand(1, 4, 9, scale=40.0)
        return (ref.layers.softcap(ref.jnp.asarray(y), 30.0),
                layers.softcap(_t(y), 30.0))
    if name.startswith("rope"):
        q = _rand(1, 2, 6, 3, 20)
        pos = np.random.default_rng(2).integers(0, 500, (2, 6))
        kw = {"theta": 1e6, "fraction": 0.25 if "partial" in name else 1.0}
        return (ref.rope.rope(ref.jnp.asarray(q), ref.jnp.asarray(pos), **kw),
                rope.rope(_t(q), _t(pos), **kw))
    if name == "mrope":
        q = _rand(1, 2, 6, 3, 16)
        pos = np.random.default_rng(2).integers(0, 50, (2, 3, 6))
        kw = {"sections": (2, 3, 3), "theta": 1e4}
        return (ref.rope.mrope(ref.jnp.asarray(q), ref.jnp.asarray(pos), **kw),
                rope.mrope(_t(q), _t(pos), **kw))
    if name == "mask_bias":
        qp = np.random.default_rng(1).integers(-2, 20, (2, 5))
        kp = np.random.default_rng(2).integers(-3, 20, (2, 9))
        # (B, 1, K) without a causal or window test: broadcast to (B, Q, K)
        return (np.stack([np.broadcast_to(ref.attn.mask_bias(
            ref.jnp.asarray(qp), ref.jnp.asarray(kp), causal=c, window=w),
            (2, 5, 9))
            for c in (True, False) for w in (None, 4)]),
            torch.stack([attention.mask_bias(
                _t(qp), _t(kp), causal=c, window=w).expand(2, 5, 9)
                for c in (True, False) for w in (None, 4)]))
    raise KeyError(name)


LAYER_CASES = ["rmsnorm", "rmsnorm_zero_centered", "layernorm", "dense",
               "dense_bias", "embed", "unembed", "mlp_silu", "mlp_gelu",
               "mlp_ungated", "softcap", "rope", "rope_partial", "mrope",
               "mask_bias"]


@pytest.mark.parametrize("name", LAYER_CASES)
def test_layer_functions_match_reference(ref, name):
    want, got = _layer_case(ref, name)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("window,cap", [(None, 0.0), (6, 0.0), (None, 20.0),
                                        (6, 20.0)])
def test_full_attention_matches_reference(ref, window, cap):
    q, k, v = _rand(1, 2, 7, 4, 8), _rand(2, 2, 11, 2, 8), _rand(3, 2, 11,
                                                                 2, 8)
    qp = np.broadcast_to(np.arange(4, 11), (2, 7)).copy()
    kp = np.broadcast_to(np.arange(11), (2, 11)).copy()
    kp[1, 9:] = -1                       # empty slots in one sequence
    kw = dict(causal=True, window=window, logit_cap=cap)
    want = ref.attn.full_attention(*map(ref.jnp.asarray, (q, k, v)),
                                   q_pos=ref.jnp.asarray(qp),
                                   k_pos=ref.jnp.asarray(kp), **kw)
    got = attention.full_attention(_t(q), _t(k), _t(v), q_pos=_t(qp),
                                   k_pos=_t(kp), **kw)
    _close(got, want)


def _attn_params(ref, seed, d=32, h=4, kv=2, dh=8):
    specs = ref.attn.attn_specs(d, h, kv, dh, qkv_bias=True)
    p = _np(ref.module.init_tree(specs, ref.jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for n in ("q", "k", "v"):            # non-zero biases
        p[n]["bias"] = rng.normal(0, 0.3, p[n]["bias"].shape).astype(
            np.float32)
    return p


@pytest.mark.parametrize("s", [12, 40])          # below / above the block
@pytest.mark.parametrize("kind", ["global", "local+cap"])
def test_self_attention_matches_reference(ref, s, kind):
    """The port's prefill attention (the flash kernel's plain version here)
    against the reference's: full at S=12, blockwise (block 32) at S=40."""
    p = _attn_params(ref, 1)
    x = _rand(2, 2, s, 32)
    kw = dict(n_kv_heads=2, causal=True, rope_theta=1e4)
    if kind != "global":
        kw.update(window=8, logit_cap=20.0)
    pos = np.broadcast_to(np.arange(s), (2, s))
    want = ref.attn.self_attention(p, ref.jnp.asarray(x), ref.jnp.asarray(pos),
                                   block_size=32, **kw)
    got = attention.self_attention(module.params_from_numpy(p), _t(x),
                                   **kw)
    _close(got, want)
    # a caller's positions take the materialised scores on the CPU
    shifted = pos + 5
    want = ref.attn.self_attention(p, ref.jnp.asarray(x),
                                   ref.jnp.asarray(shifted),
                                   **kw)
    got = attention.self_attention(module.params_from_numpy(p), _t(x),
                                   _t(shifted), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_and_cache_match_reference(ref, window):
    """Eleven steps of two sequences at different positions, through a full
    cache of 8 (positions clamp to the last slot past it) or a rolling
    window of 4 (key positions wrap, kpos sentinels): the outputs and the
    cache, written in place in the port, equal the reference's.  fp32
    caches, so the comparison sees the slots and masks and no bf16
    rounding (the models' bf16 caches are held below)."""
    p = _attn_params(ref, 2)
    rp = ref.jax.tree_util.tree_map(ref.jnp.asarray, p)
    pp = module.params_from_numpy(p)
    kw = dict(n_kv_heads=2, window=window, logit_cap=20.0, rope_theta=1e4)
    ref_cache = ref.attn.init_kv_cache(2, 8, 2, 8, window=window,
                                       dtype=ref.jnp.float32)
    cache = attention.init_kv_cache(2, 8, 2, 8, window=window,
                                    dtype=torch.float32)
    start = np.array([0, 3])
    for step in range(11):
        x = _rand(10 + step, 2, 1, 32)
        pos = start + step
        want, ref_cache = ref.attn.decode_attention(
            rp, ref.jnp.asarray(x), ref_cache,
            ref.jnp.asarray(pos, ref.jnp.int32), **kw)
        got, out_cache = attention.decode_attention(pp, _t(x), cache,
                                                    _t(pos), **kw)
        assert out_cache is cache
        _close(got, want)
        assert set(cache) == set(ref_cache)
        for key in cache:
            if key == "kpos":
                np.testing.assert_array_equal(cache[key].numpy(),
                                              np.asarray(ref_cache[key]))
            else:
                _close(cache[key], ref_cache[key])


def test_flash_attention_wrapper_takes_bf16_on_cpu():
    """``ops.attention`` with bf16 operands (GQA, head dim 128): the plain
    version in fp32 on the widened operands, the result in bf16."""
    q = _t(_rand(1, 2, 19, 4, 128)).bfloat16()
    k = _t(_rand(2, 2, 19, 2, 128)).bfloat16()
    v = _t(_rand(3, 2, 19, 2, 128)).bfloat16()
    got = fa_ops.attention(q, k, v, causal=True, window=8, logit_cap=50.0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = fa_ops.attention(q.float(), k.float(), v.float(), causal=True,
                            window=8, logit_cap=50.0)
    assert torch.equal(got, want.bfloat16())


# ---------------------------------------------------------------------------
# the model: forward, decode_step, prefill, serve_step
# ---------------------------------------------------------------------------

def _model(ref, name, dtype, seed=0):
    rc, pc = _configs(ref, name)
    rc, pc = (c.replace(activation_dtype=dtype) for c in (rc, pc))
    rp = ref.module.init_tree(ref.tr.model_specs(rc), ref.jax.random.key(seed))
    return rc, pc, rp, module.params_from_numpy(_np(rp))


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _decode_all(step, cache, toks, dev_pos):
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(toks[:, t:t + 1], cache, dev_pos(t))
        outs.append(lg)
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_reference(ref, name, dtype):
    rc, pc, rp, pp = _model(ref, name, dtype)
    s = rc.attn_block_size + 8           # the reference goes blockwise
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, s))
    want = np.asarray(ref.tr.forward(rc, rp, ref.jnp.asarray(toks))[0])
    got = transformer.forward(pc, pp, _t(toks))[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    want_pre = np.asarray(ref.lm.prefill(rc, rp, ref.jnp.asarray(toks)))
    got_pre = lm.prefill(pc, pp, _t(toks))
    assert got_pre.shape == want_pre.shape

    n_dec = 10
    cache = transformer.init_cache(pc, 2, n_dec + 2)
    got_dec = torch.stack(_decode_all(
        lambda t, c, p: transformer.decode_step(pc, pp, _t(t), c, p),
        cache, toks[:, :n_dec], lambda t: torch.full((2,), t)), 1)

    if dtype == "float32":
        ref_step = ref.jax.jit(lambda t, c, p: ref.tr.decode_step(rc, rp, t, c,
                                                              p))
        want_dec = np.stack(_decode_all(
            lambda t, c, p: ref_step(ref.jnp.asarray(t), c, p),
            ref.tr.init_cache(rc, 2, n_dec + 2), toks[:, :n_dec],
            lambda t: ref.jnp.full((2,), t, ref.jnp.int32)), 1)
        for g, w in ((got, want), (got_pre, want_pre), (got_dec, want_dec)):
            assert _scale_err(g, w) <= FP32_SCALE_TOL
            np.testing.assert_array_equal(g.argmax(-1).numpy(),
                                          np.asarray(w).argmax(-1))
    else:
        rc32 = rc.replace(activation_dtype="float32")
        ref32 = np.asarray(ref.tr.forward(rc32, rp, ref.jnp.asarray(toks))[0])
        ref_err = _scale_err(want, ref32)
        assert _scale_err(got, ref32) <= max(BF16_SCALE_TOL, 2 * ref_err)
        assert _scale_err(got_pre, ref32[:, -1]) <= max(BF16_SCALE_TOL,
                                                        2 * ref_err)
        assert _scale_err(got_dec, ref32[:, :n_dec]) <= max(
            BF16_SCALE_TOL, 2 * ref_err)

    # serve_step: the greedy token of the decode step, as int32
    ref_cache = ref.tr.init_cache(rc, 2, 4)
    cache = transformer.init_cache(pc, 2, 4)
    nxt, cache = lm.serve_step(pc, pp, _t(toks[:, :1]), cache,
                               torch.zeros(2, dtype=torch.int64))
    want_nxt, _ = ref.lm.serve_step(rc, rp, ref.jnp.asarray(toks[:, :1]),
                                    ref_cache, ref.jnp.zeros(2, ref.jnp.int32))
    assert nxt.dtype == torch.int32
    if dtype == "float32":
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(want_nxt))


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_forward(name):
    """Token-by-token decode through the bf16 cache reproduces the full
    forward at the default bf16 activations, both attending with the
    materialised scores (positions given: the decode step's attention,
    bf16 probabilities).  The flash kernel's forward keeps the
    probabilities in fp32; its gap to the decode step is a property of the
    kernel, held on the card at Qwen2.5-3B's width (``chip_smoke.py``).
    An MoE routes dropless here (``capacity_factor = n_experts``): at the
    served capacity the decode step's two tokens and the forward's 24 drop
    different assignments, in the reference as in the port."""
    cfg = _port_config(name)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(1))
    s = 12
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, s)))
    full = transformer.forward(cfg, params, toks,
                               torch.arange(s).expand(2, s))[0]
    cache = transformer.init_cache(cfg, 2, s + 4)
    dec = torch.stack(_decode_all(
        lambda t, c, p: transformer.decode_step(cfg, params, t, c, p),
        cache, toks, lambda t: torch.full((2,), t)), 1)
    assert _scale_err(dec, full.numpy()) <= DECODE_SCALE_TOL


@pytest.mark.parametrize("change,what", [
    (dict(learned_positions=True, max_position=64), "learned positions"),
    (dict(bf16_reduce=True), "bf16 cross-device"),
])
def test_unported_parts_raise(change, what):
    """A part of the reference the port does not run raises, naming it.
    bf16 cross-device sums were such a part until ROADMAP.md item 8.6
    ported them: that case now checks that the config runs."""
    cfg = ModelConfig(**BLOCK_CONFIGS["dense-gqa"]).replace(**change)
    if what == "bf16 cross-device":
        params = module.init_tree(transformer.model_specs(cfg),
                                  torch.Generator().manual_seed(0))
        transformer.init_cache(cfg, 1, 8)
        logits = transformer.forward(cfg, params,
                                     torch.zeros(1, 2, dtype=torch.int64))[0]
        assert torch.isfinite(logits).all()
        return
    for fn in (lambda: transformer.model_specs(cfg),
               lambda: transformer.init_cache(cfg, 1, 8),
               lambda: transformer.forward(cfg, {}, torch.zeros(1, 2))):
        with pytest.raises(NotImplementedError, match=what) as e:
            fn()
        assert "item 8" in str(e.value)


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
@pytest.mark.parametrize("s", [333, 1024])
def test_flash_attention_bf16_gqa_on_card(cuda, s):
    """K5 at the LM's head dim (128), 16 query heads over 2 KV heads, bf16
    in through ``ops.attention``: against its plain version on the same
    widened operands (the reference kernel's 1e-4 tolerance), rounded to
    bf16 like the kernel's result."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(2, s, h, 128, generator=g, device=cuda
                           ).bfloat16() for h in (16, 2, 2))
    for kw in ({"causal": True}, {"causal": True, "window": 128,
                                  "logit_cap": 50.0}):
        n = flash_attention.launches
        got = fa_ops.attention(q, k, v, **kw)
        assert flash_attention.launches == n + 1
        assert got.dtype == torch.bfloat16
        qh = q.float().transpose(1, 2).reshape(32, s, 128)
        kh, vh = (t.float().transpose(1, 2).repeat_interleave(8, dim=1
                                                              ).reshape(
            32, s, 128) for t in (k, v))
        want = flash_attention_ref(qh, kh, vh, **kw).reshape(
            2, 16, s, 128).transpose(1, 2)
        assert torch.allclose(got.float(), want.bfloat16().float(),
                              rtol=1e-2, atol=1e-2)
        full = fa_ops.attention(q.float(), k.float(), v.float(), **kw)
        assert torch.allclose(full, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_decode_tick_on_card_matches_cpu(cuda):
    """One engine tick's decode step (8 lanes at scattered positions) on
    the card against the same step on the CPU, qwen2.5-tiny at bf16 with
    the same weights and cache: within the bf16 bar."""
    cfg = registry.get_tiny("qwen2.5-3b")
    cpu_params = module.init_tree(transformer.model_specs(cfg),
                                  torch.Generator().manual_seed(0))
    params = module.map_tree(lambda a: a.to(cuda), cpu_params)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 24)))
    caches = {}
    for dev, p in (("cpu", cpu_params), ("cuda", params)):
        cache = transformer.init_cache(cfg, 8, 32, device=dev)
        for t in range(24):
            logits, cache = transformer.decode_step(
                cfg, p, toks[:, t:t + 1].to(dev), cache,
                torch.full((8,), t, device=dev))
        caches[dev] = logits.float().cpu()
    assert _scale_err(caches["cuda"], caches["cpu"].numpy()) <= \
        BF16_SCALE_TOL
