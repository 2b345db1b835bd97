"""Qwen2-VL in the port (qwen2-vl-2b), held against the reference
package: the config and spec tree, ``forward`` with precomputed patch
embeddings in front of the tokens, ``lm.prefill`` with them, the engine
on text, and ``self_attention`` at a caller's M-RoPE positions (B, 3, S)
below and above ``attn_block_size``.  The decode step on text is held in
``tests/test_torch_lm.py``'s model tests, which take every decoder of the
registry.

Both packages get the same numpy inputs and weights, drawn from a seed by
the reference's ``init_tree`` rule over its spec tree; activations are
fp32.  Tolerances:

* the model's logits within 1e-4 of their scale (max |logit|), greedy
  tokens equal: the LM's bar (``PERF.md`` §2);
* self-attention at rtol 1e-5 / atol 1e-6: the same fp32 arithmetic in
  another framework;
* the engine's token lists equal the reference engine's.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import attention, module, transformer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCH = "qwen2-vl-2b"
FP32_SCALE_TOL = 1e-4
RTOL, ATOL = 1e-5, 1e-6
#: the reference's param_count of qwen2-vl-2b
PARAMS = 1_543_715_840


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.models import lm as ref_lm
    from repro.nn import attention as ref_attn
    from repro.nn import module as ref_module
    from repro.nn import transformer as ref_tr
    from repro.serving.engine import ServingEngine as RefEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=ref_registry,
                                 lm=ref_lm, attn=ref_attn, module=ref_module,
                                 tr=ref_tr, Engine=RefEngine)


def _init(ref, specs, seed):
    """The reference's ``init_tree`` rule, drawn with numpy (normal at
    ``scale`` or 1/sqrt(fan_in), zeros, ones)."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale if spec.scale is not None else spec.fan_in() ** -0.5
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return ref.module.map_specs(draw, specs)


@pytest.fixture(scope="module")
def model(ref):
    """(reference config, port config, reference params, port params) of
    qwen2-vl-2b's tiny config at fp32, its QKV biases and norms drawn
    away from their zeros and ones so they show."""
    rc = ref.registry.get_tiny(ARCH).replace(activation_dtype="float32")
    pc = registry.get_tiny(ARCH).replace(activation_dtype="float32")
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    w = _init(ref, ref.tr.model_specs(rc), 0)
    rng = np.random.default_rng(1)
    for path in (("patch_norm", "scale"), ("final_norm", "scale")):
        w[path[0]][path[1]] = rng.uniform(0.5, 1.5, w[path[0]][path[1]].shape
                                          ).astype(np.float32)
    for n in ("q", "k", "v"):
        b = w["blocks"]["0"]["mixer"][n]["bias"]
        w["blocks"]["0"]["mixer"][n]["bias"] = rng.normal(
            0, 0.3, b.shape).astype(np.float32)
    return rc, pc, ref.jax.tree_util.tree_map(ref.jnp.asarray, w), \
        module.params_from_numpy(w)


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_config_and_spec_tree(ref):
    cfg = registry.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref.registry.get_config(ARCH))
    specs = transformer.model_specs(cfg)
    assert "patch_norm" in specs
    assert module.param_count(specs) == PARAMS == ref.module.param_count(
        ref.tr.model_specs(ref.registry.get_config(ARCH)))
    assert ARCH in registry.ARCH_IDS and not registry.NOT_PORTED


@pytest.mark.parametrize("with_patches", [True, False])
def test_forward_and_prefill_match_reference(ref, model, with_patches):
    """Patches (B, n_patches, d) in front of S tokens, S + P above the
    tiny config's block of 64, so the reference attends blockwise."""
    rc, pc, rp, pp = model
    rng = np.random.default_rng(2)
    s = rc.attn_block_size + 8 - (rc.n_patches if with_patches else 0)
    toks = rng.integers(0, rc.vocab_size, (2, s))
    patches = rng.standard_normal((2, rc.n_patches, rc.d_model)).astype(
        np.float32) if with_patches else None
    jp = None if patches is None else ref.jnp.asarray(patches)
    tp = None if patches is None else torch.from_numpy(patches)
    want, want_aux = ref.jax.jit(lambda t, p: ref.tr.forward(
        rc, rp, t, patches=p))(ref.jnp.asarray(toks), jp)
    got, aux = transformer.forward(pc, pp, torch.from_numpy(toks),
                                   patches=tp)
    assert got.shape == want.shape == (2, rc.attn_block_size + 8,
                                       rc.vocab_size)
    assert float(aux) == float(want_aux) == 0.0
    assert _scale_err(got, want) <= FP32_SCALE_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    want_pre = ref.lm.prefill(rc, rp, ref.jnp.asarray(toks), patches=jp)
    got_pre = lm.prefill(pc, pp, torch.from_numpy(toks), patches=tp)
    assert _scale_err(got_pre, want_pre) <= FP32_SCALE_TOL


def test_patches_change_the_logits(model):
    """The patch_norm and the patches reach the text positions."""
    _, pc, _, pp = model
    toks = torch.arange(8)[None].expand(2, 8)
    patches = torch.randn(2, pc.n_patches, pc.d_model,
                          generator=torch.Generator().manual_seed(3))
    a = transformer.forward(pc, pp, toks, patches=patches)[0][:, -8:]
    b = transformer.forward(pc, pp, toks, patches=2 * patches)[0][:, -8:]
    c = transformer.forward(pc, pp, toks)[0]
    assert not torch.allclose(a, c) and not torch.allclose(a, b)


@pytest.mark.parametrize("s", [48, 80])
def test_self_attention_at_mrope_positions_matches_reference(ref, model, s):
    """(B, 3, S) M-RoPE positions with distinct t/h/w streams: the full
    path at S 48 and the blockwise one at S 80 (block 64, a ragged last
    block) in both packages, on the CPU."""
    rc, pc, rp, pp = model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, rc.d_model)).astype(np.float32)
    pos = np.stack([np.arange(s), np.arange(s) // 4, np.arange(s) % 4])
    pos = np.broadcast_to(pos[None], (2, 3, s)).astype(np.int32)
    kw = dict(n_kv_heads=rc.n_kv_heads, causal=True,
              rope_theta=rc.rope_theta, mrope_sections=rc.mrope_sections,
              block_size=rc.attn_block_size)
    p_ref = ref.jax.tree_util.tree_map(lambda a: a[0],
                                       rp["blocks"]["0"]["mixer"])
    want = ref.jax.jit(lambda p, a, q: ref.attn.self_attention(
        p, a, q, **kw))(p_ref, ref.jnp.asarray(x), ref.jnp.asarray(pos))
    p_port = module.map_tree(lambda a: a[0], pp["blocks"]["0"]["mixer"])
    got = attention.self_attention(p_port, torch.from_numpy(x),
                                   torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_engine_tokens_equal_reference(ref, model):
    """The engine serves text, as the reference's launcher does: its token
    lists over six requests on three lanes equal the reference engine's."""
    rc, pc, rp, pp = model
    requests = [([5, 6, 7, 8], 6), ([9, 10], 5), ([11, 12, 13], 7),
                ([1], 4), ([2, 3, 4, 5, 6, 7, 8], 3), ([30, 31], 9)]
    outs = []
    for eng in (ref.Engine(rc, rp, max_batch=3, max_len=32),
                ServingEngine(pc, pp, max_batch=3, max_len=32)):
        for prompt, n in requests:
            eng.submit(prompt, max_new_tokens=n)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
    assert outs[1] == outs[0]


def test_launcher_serves_qwen2_vl():
    from repro_torch.launch import serve
    s = serve.main(["--arch", ARCH, "--requests", "3", "--device", "cpu",
                    "--new-tokens", "4"])
    assert s["requests"] == 3 and s["generated_tokens"] == 12


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [48, 80])
def test_self_attention_at_mrope_positions_on_card(cuda, s):
    """A caller's (B, 3, S) positions run on the card (the full path at S
    48, the blockwise one at S 80) and equal the CPU run at rtol 1e-4 /
    atol 1e-5 (fp32 sums in other orders), gradients included."""
    cfg = registry.get_tiny(ARCH)
    p = module.map_tree(lambda a: a[0], module.init_tree(
        transformer.model_specs(cfg), torch.Generator().manual_seed(0)
    )["blocks"]["0"]["mixer"])
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator(
    ).manual_seed(1))
    pos = torch.stack([torch.arange(s), torch.arange(s) // 4,
                       torch.arange(s) % 4]).expand(2, 3, s)
    kw = dict(n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
              mrope_sections=cfg.mrope_sections,
              block_size=cfg.attn_block_size)
    out = {}
    for dev in ("cpu", cuda):
        xt = x.detach().to(dev).requires_grad_()
        y = attention.self_attention(module.map_tree(
            lambda a: a.to(dev), p), xt, pos.to(dev), **kw)
        y.sum().backward()
        out[str(dev)] = (y.detach().cpu(), xt.grad.cpu())
    for a, b in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
