"""The encoder-decoder (whisper-tiny) in the port, held against the
reference package: the config and spec tree, ``cross_attention``,
``encode``, ``decode_forward``, ``serve_step`` and its cache, greedy
generation through the step's runner, and the launcher's refusal.

Both packages get the same numpy frames, tokens and weights, drawn from a
seed (the weights by the reference's ``init_tree`` rule over its spec
tree).  Tolerances:

* ``cross_attention`` at fp32, rtol 1e-5 / atol 1e-6: the same fp32
  arithmetic in another framework;
* ``encode``, ``decode_forward`` and the step's logits at fp32: within
  1e-4 of the scale (max |y|), greedy tokens and the KV cache's bf16
  values equal; the LM's bar (``PERF.md`` §2).  On the CPU the port's
  self-attention runs the flash kernel's plain version, the reference its
  full or blockwise attention;
* at bf16: within max(2%, 2 x the reference's own bf16 error) of the scale
  from the reference's fp32 output, the LM's bf16 bar;
* the port's cached steps against its own ``decode_forward``: 1% of the
  logit scale, the reference's decode bar;
* on the card: within 1e-3 of the scale of the CPU run at fp32, and a
  replayed step equal to the eager one value for value.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.nn import attention, module, transformer  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FP32_SCALE_TOL = 1e-4
BF16_SCALE_TOL = 0.02
DECODE_SCALE_TOL = 0.01
CARD_SCALE_TOL = 1e-3
ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (they import JAX, which the card's
    machine does not have: the ``gpu`` tests below do without them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.models import encdec as ref_encdec
    from repro.nn import attention as ref_attn
    from repro.nn import module as ref_module
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=ref_registry,
                                 encdec=ref_encdec, attn=ref_attn,
                                 module=ref_module)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _init(map_specs, specs, seed):
    """Weights drawn with numpy by the reference's ``init_tree`` rule
    (normal at ``scale`` or 1/sqrt(fan_in), zeros, ones)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale if spec.scale is not None else spec.fan_in() ** -0.5
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return map_specs(draw, specs)


def _model(ref, dtype="float32"):
    """(reference config, port config, reference params, port params) of
    whisper-tiny's tiny()."""
    rc = ref.registry.get_tiny(ARCH).replace(activation_dtype=dtype)
    pc = registry.get_tiny(ARCH).replace(activation_dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    w = _init(ref.module.map_specs, ref.encdec.model_specs(rc), 0)
    return rc, pc, ref.jax.tree_util.tree_map(ref.jnp.asarray, w), \
        module.params_from_numpy(w)


def _frames(cfg, b=2, seed=3):
    return _rand(seed, b, cfg.encoder_len, cfg.d_model)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


# ---------------------------------------------------------------------------
# config, spec tree, cross-attention
# ---------------------------------------------------------------------------

def test_spec_tree_and_count_equal_reference(ref):
    for get, ref_get in ((registry.get_config, ref.registry.get_config),
                         (registry.get_tiny, ref.registry.get_tiny)):
        port = encdec.model_specs(get(ARCH))
        want = ref.encdec.model_specs(ref_get(ARCH))
        fields = (lambda v: (tuple(v.shape), tuple(v.axes), v.init, v.scale))
        assert {k: fields(v) for k, v in _flat(port).items()} == \
            {k: fields(v) for k, v in _flat(want).items()}
        assert module.param_count(port) == ref.module.param_count(want)
    full = registry.get_config(ARCH)
    assert (full.n_encoder_layers, full.n_layers, full.d_model,
            full.encoder_len) == (4, 4, 384, 1500)
    assert module.param_count(encdec.model_specs(full)) == 38_599_680


@pytest.mark.parametrize("s,t", [(1, 24), (7, 40)])
def test_cross_attention_matches_reference(ref, s, t):
    specs = ref.attn.attn_specs(32, 4, 4, 8)
    w = _init(ref.module.map_specs, specs, 5)
    x, enc = _rand(6, 2, s, 32), _rand(7, 2, t, 32)
    want = ref.jax.jit(lambda p, a, e: ref.attn.cross_attention(
        p, a, e, n_kv_heads=4))(w, x, enc)
    got = attention.cross_attention(module.params_from_numpy(w), _t(x),
                                    _t(enc), n_kv_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# encode, decode_forward, serve_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_decode_forward_match_reference(ref, dtype):
    rc, pc, rp, pp = _model(ref, dtype)
    frames = _frames(pc)
    toks = np.random.default_rng(4).integers(0, pc.vocab_size, (2, 10))
    def run(c):
        return ref.jax.jit(lambda p, f, t: (
            ref.encdec.encode(c, p, f),
            ref.encdec.decode_forward(c, p, t, ref.encdec.encode(c, p, f))))
    want_enc, want = run(rc)(rp, frames, toks)
    enc = encdec.encode(pc, pp, _t(frames))
    got = encdec.decode_forward(pc, pp, _t(toks), enc)
    assert enc.dtype == getattr(torch, dtype) and got.dtype == torch.float32
    assert got.shape == (2, 10, pc.vocab_size)
    last = encdec.decode_forward(pc, pp, _t(toks), enc, last_logit_only=True)
    torch.testing.assert_close(last, got[:, -1:], rtol=RTOL, atol=ATOL)
    if dtype == "float32":
        assert _scale_err(enc, want_enc) <= FP32_SCALE_TOL
        assert _scale_err(got, want) <= FP32_SCALE_TOL
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
    else:
        rc32 = rc.replace(activation_dtype="float32")
        _, ref32 = run(rc32)(rp, frames, toks)
        bar = max(BF16_SCALE_TOL, 2 * _scale_err(want, ref32))
        assert _scale_err(got, ref32) <= bar


def test_serve_step_and_cache_match_reference(ref):
    """Eight steps at fp32 from a teacher-forced prompt: the next tokens
    equal the reference's, and so does the KV cache the steps wrote in
    place."""
    rc, pc, rp, pp = _model(ref)
    frames = _frames(pc)
    toks = np.random.default_rng(5).integers(1, pc.vocab_size, (2, 8))
    enc = encdec.encode(pc, pp, _t(frames))
    ref_enc = ref.jax.jit(lambda p, f: ref.encdec.encode(rc, p, f))(
        rp, frames)
    ref_cache = ref.encdec.init_cache(rc, 2, 12, ref_enc)
    cache = encdec.init_cache(pc, 2, 12, enc=enc)
    ref_step = ref.jax.jit(lambda t, c, p: ref.encdec.serve_step(rc, rp, t,
                                                                c, p))
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        want, ref_cache = ref_step(toks[:, t:t + 1], ref_cache, pos)
        got, same = encdec.serve_step(pc, pp, _t(toks[:, t:t + 1]), cache,
                                      _t(pos).long())
        assert same is cache and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("k", "v"):
        assert cache["self"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            cache["self"][name].float().numpy(),
            np.asarray(ref_cache["self"][name], np.float32))


def test_decode_steps_match_decode_forward():
    """The port's cached steps (bf16 KV cache) against its own
    teacher-forced forward at bf16 activations: 1% of the logit scale."""
    cfg = registry.get_tiny(ARCH)
    params = module.init_tree(encdec.model_specs(cfg),
                              torch.Generator().manual_seed(1))
    frames = torch.from_numpy(_frames(cfg, seed=8))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)))
    enc = encdec.encode(cfg, params, frames)
    full = encdec.decode_forward(cfg, params, toks, enc)
    cache = encdec.init_cache(cfg, 2, 16, enc=enc)
    steps = [encdec.decode_step(cfg, params, toks[:, t:t + 1], cache,
                                torch.full((2,), t))[0] for t in range(12)]
    assert _scale_err(torch.stack(steps, 1), full.numpy()) <= \
        DECODE_SCALE_TOL


def test_generate_equals_reference_serve_steps(ref):
    """Greedy generation through the step's runner (eager on the CPU):
    the tokens of the reference's serve_step loop on the same prompt."""
    rc, pc, rp, pp = _model(ref)
    frames = _frames(pc, seed=10)
    prompt = np.random.default_rng(11).integers(1, pc.vocab_size, (2, 3))
    got = encdec.generate(pc, pp, _t(frames), _t(prompt), 6)
    ref_enc = ref.jax.jit(lambda p, f: ref.encdec.encode(rc, p, f))(
        rp, frames)
    cache = ref.encdec.init_cache(rc, 2, 9, ref_enc)
    step = ref.jax.jit(lambda t, c, p: ref.encdec.serve_step(rc, rp, t, c,
                                                            p))
    tok, want = prompt[:, :1], []
    for t in range(8):
        nxt, cache = step(tok, cache, np.full((2,), t, np.int32))
        tok = prompt[:, t + 1:t + 2] if t + 1 < 3 else np.asarray(nxt)[:,
                                                                       None]
        if t + 1 >= 3:
            want.append(np.asarray(nxt))
    assert got.shape == (2, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))


def test_launcher_and_decoder_refuse_the_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
    cfg = registry.get_tiny(ARCH)
    for fn in (lambda: transformer.model_specs(cfg),
               lambda: transformer.init_cache(cfg, 1, 8),
               lambda: transformer.forward(cfg, {}, torch.zeros(1, 2))):
        with pytest.raises(NotImplementedError, match="models.encdec"):
            fn()


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
    """encode (K5, non-causal) and decode_forward (K5, causal) at fp32 on
    the card against the same on the CPU, each self-attention one K5
    launch."""
    from repro_torch.kernels import registry as kernels
    cfg = registry.get_tiny(ARCH).replace(activation_dtype="float32")
    params = module.init_tree(encdec.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    on_card = module.map_tree(lambda a: a.to(cuda), params)
    frames = torch.from_numpy(_frames(cfg, seed=12))
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 20)))
    want = encdec.decode_forward(cfg, params, toks,
                                 encdec.encode(cfg, params, frames))
    kernels.reset_launch_counts()
    got = encdec.decode_forward(cfg, on_card, toks.to(cuda),
                                encdec.encode(cfg, on_card, frames.to(cuda)))
    assert kernels.launch_counts()["flash_attention"] == \
        cfg.n_encoder_layers + cfg.n_layers
    assert _scale_err(got.cpu(), want.numpy()) <= CARD_SCALE_TOL


@pytest.mark.gpu
def test_replayed_step_equals_eager_on_card(cuda):
    """The bf16 step replayed from its captured graph writes the KV cache
    in place, equal value for value to the eager step on a copy."""
    cfg = registry.get_tiny(ARCH)
    params = module.init_tree(encdec.model_specs(cfg),
                              torch.Generator(device=cuda).manual_seed(0),
                              device=cuda)
    frames = torch.randn(3, cfg.encoder_len, cfg.d_model, device=cuda)
    cache = encdec.init_cache(cfg, 3, 16,
                              enc=encdec.encode(cfg, params, frames))
    run = encdec.step_runner(cfg, params, cache)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for t in range(6):
        toks = torch.randint(0, cfg.vocab_size, (3, 1), generator=gen,
                             device=cuda)
        pos = torch.full((3,), t, device=cuda)
        if t == 0:
            run({"tokens": toks, "pos": pos})        # eager, then capture
            continue
        twin = module.map_tree(torch.clone, cache)
        want, _ = encdec.serve_step(cfg, params, toks, twin, pos)
        assert torch.equal(run({"tokens": toks, "pos": pos}), want)
        for a, b in zip(module.tree_leaves(cache), module.tree_leaves(twin)):
            assert torch.equal(a, b)
    assert len(run.replay_launches()) == 1
