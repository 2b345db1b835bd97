"""The transformer encoder block in the port, held against the reference
package: the module graph and its fingerprint, the functional model, the
tensor twin, the nest tier (K3 projections and MLP, K2 Taylor softmax, K5
in the flash mode) and the generic DFG tier (K4).

Both packages get the reference's ``init_tree(specs, PRNGKey(0))`` as numpy
weights and the same numpy inputs, at a size the reference's kernel tiling
accepts (seq 4, d_model 8, 2 heads, ffn 16, batch 4).  On the CPU the
port's kernels run their plain PyTorch versions; the ``gpu``-marked tests
at the end run the kernels on the card at the block's full width.

Tolerances:

* ``Design.run``, both numpy ``evaluate``: bitwise;
* fp32 against the reference's jnp paths, rtol 1e-4 / atol 1e-5: the same
  arithmetic summed in another order by another framework;
* (5,4) tensor twin, rtol 5e-2 / atol 5e-3; (5,4) nest tier against the
  reference's nest tier, one (5,4) ulp at the output's scale: the
  reference's jnp quantiser leaves values off the lattice (fault R1 in
  ROADMAP.md), which can move a rounding by one step;
* the quantised nest tier against ``Design.run`` at (5,11), rtol 5e-2 /
  atol 5e-3, the reference's own check of the quantised block: the nest
  tier rounds per kernel, the DFG per op, and at (5,4) the two roundings
  part by up to 0.5 on outputs of scale 2 in either package;
* the DFG tier against ``Design.run``: value for value.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.core import frontend  # noqa: E402
from repro_torch.core.emit_cuda import to_cuda_fn  # noqa: E402
from repro_torch.core.pipeline import graph_fingerprint  # noqa: E402
from repro_torch.core.precision import FORMATS  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.smallfloat_matmul import ops as mm_ops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.nn import graph as nng  # noqa: E402
from repro_torch.nn.module import init_tree, params_from_numpy  # noqa: E402

SEQ, D, H, F, BATCH = 4, 8, 2, 16, 4
RTOL, ATOL = 1e-4, 1e-5
Q_RTOL, Q_ATOL = 5e-2, 5e-3
OUT = "ln_post_out"
#: the nest tier's plan for the block, as the reference records it
PLAN = {"smallfloat_matmul": 2, "smallfloat_matmul:relu": 1,
        "fused_softmax": 1}
FLASH_PLAN = {"smallfloat_matmul": 2, "smallfloat_matmul:relu": 1,
              "flash_attention": 1}


def _ulp_5_4(scale: float) -> float:
    """One (5,4) ulp at magnitude ``scale``."""
    return 2.0 ** (np.floor(np.log2(max(scale, 2.0 ** -14))) - 4)


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    jax = pytest.importorskip("jax")
    import repro.hls
    from repro.core import frontend as ref_frontend
    from repro.core.pipeline import graph_fingerprint as ref_fingerprint
    from repro.models import transformer as ref_transformer
    from repro.nn import graph as ref_nng
    from repro.nn.module import init_tree as ref_init_tree
    return types.SimpleNamespace(
        jax=jax, hls=repro.hls, frontend=ref_frontend,
        fingerprint=ref_fingerprint, transformer=ref_transformer,
        nng=ref_nng, init_tree=ref_init_tree)


@pytest.fixture(scope="module")
def params(ref):
    return ref.jax.tree_util.tree_map(
        np.asarray, ref.init_tree(ref.transformer.specs(SEQ, D, H, F),
                                  ref.jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_design(ref, params):
    return ref.hls.Session().compile(
        ref.transformer.build(SEQ, D, H, F, params=params))


@pytest.fixture(scope="module")
def session():
    return hls.Session(device="cpu")


@pytest.fixture(scope="module")
def design(session, params):
    return session.compile(transformer.build(
        SEQ, D, H, F, params=params_from_numpy(params)))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).normal(0, 0.5, (BATCH, SEQ, D)).astype(
        np.float32)


def _hand_build(ctx):
    frontend.transformer_encoder_block(ctx, seq=SEQ, d_model=D, n_heads=H,
                                       ffn=F)


# ---------------------------------------------------------------------------
# The module graph and the functional model
# ---------------------------------------------------------------------------

def test_fingerprint_equals_handwritten_and_reference(ref, design,
                                                      ref_design):
    assert design.fingerprint == graph_fingerprint(hls.trace(_hand_build))
    assert design.fingerprint == ref_design.fingerprint
    assert design.fingerprint == ref.fingerprint(ref.hls.trace(
        lambda ctx: ref.frontend.transformer_encoder_block(
            ctx, seq=SEQ, d_model=D, n_heads=H, ffn=F)))


def test_design_hash_equals_handwritten_and_reference(session, design,
                                                      ref_design):
    hits = session.stats()["hits"]
    d_hand = session.compile(_hand_build, name="encoder_block_hand")
    assert d_hand.design_hash == design.design_hash \
        == ref_design.design_hash
    assert session.stats()["hits"] == hits + 1


def test_specs_match_reference(ref):
    mine = transformer.specs(SEQ, D, H, F)
    theirs = ref.transformer.specs(SEQ, D, H, F)
    assert set(mine) == set(theirs) == {"attn", "mlp", "ln_post"}
    for sub in ("attn", "mlp"):
        for name in theirs[sub]:
            for leaf in theirs[sub][name]:
                assert mine[sub][name][leaf].shape == \
                    theirs[sub][name][leaf].shape


@pytest.mark.parametrize("fmt", [None, "5_4"])
def test_design_run_is_bitwise_the_reference(ref_design, design, x, fmt):
    want = ref_design.run(x, fmt=_ref_format(fmt) if fmt else None)[OUT]
    got = design.run(x, fmt=fmt and FORMATS[fmt])[OUT]
    np.testing.assert_array_equal(got, want)


def _ref_format(fmt):
    from repro.core.precision import FORMATS as REF_FORMATS
    return REF_FORMATS[fmt]


@pytest.mark.parametrize("fmt,rtol,atol", [(None, RTOL, ATOL),
                                           ("5_4", Q_RTOL, Q_ATOL)])
def test_tensor_twin_matches_reference(ref, params, x, fmt, rtol, atol):
    want = np.asarray(ref.transformer.forward(params, x, n_heads=H,
                                              fmt=fmt))
    got = transformer.forward(params_from_numpy(params), torch.from_numpy(x),
                              n_heads=H, fmt=fmt)
    assert got.shape == (BATCH, SEQ, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_taylor_exp_matches_reference(ref):
    z = np.linspace(-12, 0, 97, dtype=np.float32)
    want = np.asarray(ref.transformer.taylor_exp(z, order=8))
    got = transformer.taylor_exp(torch.from_numpy(z), order=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The nest tier against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_nest_tier_fp32_matches_reference(ref_design, design, x,
                                          use_pallas):
    rfn = ref_design.jax_fn(backend="pallas", use_pallas=use_pallas,
                            interpret=True)
    want = np.asarray(rfn(ref_design.feeds(x))[OUT])
    fn = design.torch_fn(backend="cuda", device="cpu")
    got = fn(x)[OUT]
    assert fn.plan.mode == "nests"
    assert fn.plan.kernels == rfn.plan.kernels == PLAN
    assert [f.split(":")[0] for f in fn.plan.fallbacks] == \
        [f.split(":")[0] for f in rfn.plan.fallbacks] == ["ln_post"]
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), design.run(x)[OUT], rtol=RTOL,
                               atol=ATOL)


def test_flash_mode_matches_reference(ref_design, design, x):
    rfn = ref_design.jax_fn(backend="pallas", nlb_flash=True,
                            interpret=True)
    want = np.asarray(rfn(ref_design.feeds(x))[OUT])
    fn = design.torch_fn(backend="cuda", device="cpu", nlb_flash=True)
    assert fn.plan.kernels == rfn.plan.kernels == FLASH_PLAN
    assert any("true-exp softmax" in n for n in fn.plan.notes)
    np.testing.assert_allclose(fn(x)[OUT].numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("fmt", ["5_4", "5_3"])
def test_nest_tier_quantised_matches_reference(ref_design, design, x, fmt):
    rfn = ref_design.jax_fn(backend="pallas", fmt=fmt, interpret=True)
    want = np.asarray(rfn(ref_design.feeds(x))[OUT])
    fn = design.torch_fn(backend="cuda", device="cpu", fmt=fmt)
    got = fn(x)[OUT].numpy()
    assert fn.plan.fmt == rfn.plan.fmt == fmt
    assert fn.plan.kernels == rfn.plan.kernels
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_ulp_5_4(float(np.abs(want).max())))


def test_nest_tier_quantised_matches_design_run(design, x):
    got = design.torch_fn(backend="cuda", device="cpu", fmt="5_11")(x)[OUT]
    np.testing.assert_allclose(
        got.numpy(), design.run(x, fmt=FORMATS["5_11"])[OUT], rtol=Q_RTOL,
        atol=Q_ATOL)


def test_nest_tier_binds_one_qkv_weight(design, params):
    """The q, k and v projections are one matmul over the kernels side by
    side, and that launch equals three launches value for value (the plain
    version here; the kernel in the ``gpu`` test)."""
    fn = design.torch_fn(backend="cuda", device="cpu")
    from repro_torch.core.emit_cuda import _normalize_weights
    w = _normalize_weights(design.module.weight_feeds(), design.module)
    qkv = w["attn.qkv"]
    assert qkv.shape == (D, 3 * D)
    for i, nm in enumerate("qkv"):
        np.testing.assert_array_equal(
            qkv[:, i * D:(i + 1) * D], params["attn"][nm]["kernel"]
            .reshape(D, D))
    assert fn.plan.kernels["smallfloat_matmul"] == 2


def test_mlp_is_one_chain_launch(design, x, monkeypatch):
    """fc1 + ReLU and fc2 go to one ``matmul_chain`` call per batch; with
    the projections (two chains of one) that is three matmul calls."""
    calls = []
    real = mm_ops.matmul_chain

    def counting(x2, layers, **kw):
        calls.append(len(layers))
        return real(x2, layers, **kw)

    monkeypatch.setattr(mm_ops, "matmul_chain", counting)
    design.torch_fn(backend="cuda", device="cpu")(x)
    assert calls == [2]


# ---------------------------------------------------------------------------
# The DFG tier, the serving backends and the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [None, "5_4", "5_3"])
def test_dfg_tier_equals_design_run(design, x, fmt):
    fn = design.torch_fn(backend="cuda", device="cpu", mode="dfg", fmt=fmt)
    got = fn({"input": x})[OUT].numpy()
    want = design.run(x, fmt=fmt and FORMATS[fmt])[OUT]
    assert fn.plan.n_segments == 1 and not fn.plan.fallbacks
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend,fmt,cuda_kw", [
    ("cuda", None, None), ("cuda", None, {"nlb_flash": True}),
    ("cuda", None, {"mode": "dfg"}), ("tensor", None, None),
    ("simd", None, None)])
def test_serve_paths_on_cpu(design, x, backend, fmt, cuda_kw):
    registry.reset_launch_counts()
    rep = design.serve([x, x[:3]], backend=backend, fmt=fmt,
                       cuda_kw=cuda_kw, device="cpu", collect=True)
    assert rep.batches == 2 and rep.samples == BATCH + 3
    assert not any(registry.launch_counts().values())   # plain versions
    want = design.run(x)[OUT]
    for out, n in zip(rep.outputs, (BATCH, 3)):
        got = out[OUT] if isinstance(out, dict) else out
        tol = 5e-2 if cuda_kw and cuda_kw.get("nlb_flash") else ATOL
        np.testing.assert_allclose(got.numpy().reshape(n, SEQ, D), want[:n],
                                   rtol=RTOL, atol=tol)


def test_verify_passes_on_cpu(design):
    rep = design.verify(device="cpu")
    assert rep.passed, rep.summary()


@pytest.mark.parametrize("pre_norm,residual", [(False, False), (True, False),
                                               (False, True)])
def test_variants_lower_like_the_reference(ref, pre_norm, residual):
    """The sub-block flags change the emitted structure; each variant lowers
    through the nest tier with the reference's plan and output."""
    def nodes(ng):
        return [ng.Attention("attn", d_model=D, n_heads=H, pre_norm=pre_norm,
                             residual=residual),
                ng.MLP("mlp", d_model=D, hidden=F, pre_norm=pre_norm,
                       residual=residual),
                ng.RMSNorm("ln_post", dim=D)]
    ref_m = ref.nng.ModuleGraph("variant", (SEQ, D), nodes(ref.nng))
    p = ref.jax.tree_util.tree_map(
        np.asarray, ref_m.init_params(ref.jax.random.PRNGKey(3)))
    ref_m = ref_m.bind(p)
    m = nng.ModuleGraph("variant", (SEQ, D), nodes(nng),
                        params=params_from_numpy(p))
    g = hls.trace(m)
    full = hls.trace(transformer.build(SEQ, D, H, F))
    assert 0 < len(g.ops) < len(full.ops)
    assert ("attn.norm.gamma" in g.inputs) == pre_norm
    assert graph_fingerprint(g) == ref.fingerprint(ref.hls.trace(ref_m))
    xs = np.random.default_rng(4).normal(0, 0.5, (BATCH, SEQ, D)).astype(
        np.float32)
    from repro.core.emit_pallas import to_pallas_fn
    rfn = to_pallas_fn(None, module=ref_m)
    want = np.asarray(rfn({"input": xs, **ref_m.weight_feeds()})[OUT])
    fn = to_cuda_fn(None, module=m, device="cpu")
    assert fn.plan.kernels == rfn.plan.kernels == PLAN
    np.testing.assert_allclose(fn(xs)[OUT].numpy(), want, rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# On the card: the block's paths at full width, and its kernels' shapes
# ---------------------------------------------------------------------------

FULL = (16, 64, 4, 256)          # seq, d_model, heads, ffn: build()'s own


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_design(cuda):
    m = transformer.build(*FULL)
    return hls.compile(m.bind(init_tree(m.specs(),
                                        torch.Generator().manual_seed(0))))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,cuda_kw", [(None, {}), ("5_4", {}),
                                         (None, {"nlb_flash": True})])
@pytest.mark.parametrize("b", [256, 100])
def test_block_nest_tier_on_card_matches_cpu(full_design, b, fmt, cuda_kw):
    x = np.random.default_rng(b).normal(0, 0.5, (b, *FULL[:2])).astype(
        np.float32)
    registry.reset_launch_counts()
    got = full_design.torch_fn(backend="cuda", fmt=fmt, **cuda_kw)(x)[OUT]
    counts = registry.launch_counts()
    assert counts["smallfloat_matmul"] == 3          # qkv, out, the MLP
    attn = "flash_attention" if cuda_kw else "fused_softmax"
    assert counts[attn] == 1
    want = full_design.torch_fn(backend="cuda", fmt=fmt, device="cpu",
                                **cuda_kw)(x)[OUT]
    got = got.cpu().numpy()
    if fmt:
        atol = _ulp_5_4(float(want.abs().max()))
        assert np.abs(got - want.numpy()).max() <= atol
        assert (got != want.numpy()).mean() <= 0.01
    else:
        np.testing.assert_allclose(got, want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [None, "5_4"])
def test_block_dfg_tier_on_card_equals_design_run(full_design, fmt):
    x = np.random.default_rng(7).normal(0, 0.5, (6, *FULL[:2])).astype(
        np.float32)
    fn = full_design.torch_fn(backend="cuda", mode="dfg", fmt=fmt)
    registry.reset_launch_counts()
    got = fn({"input": x})[OUT].cpu().numpy()
    assert registry.launch_counts()["dfg_segment"] == fn.plan.n_segments
    np.testing.assert_array_equal(
        got, full_design.run(x, fmt=fmt and FORMATS[fmt])[OUT])


def _rand(cuda, *shape, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(
        np.float32)).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", [None, (5, 4)])
def test_block_matmuls_on_card(cuda, fmt):
    """K3 at the block's shapes (M = 4,096 rows): the q/k/v projection as
    one launch equals three launches value for value, and the 64 -> 256 ->
    64 MLP chain, whose weights take about 140 KB of shared memory, equals
    its layers launched one at a time, and both match the plain version."""
    from repro_torch.kernels.smallfloat_matmul.ref import Dense
    from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import (
        smallfloat_matmul, smallfloat_matmul_chain)
    m, d, hidden = 256 * FULL[0], FULL[1], FULL[3]
    eb, mb = fmt if fmt else (None, None)
    kw = {"exp_bits": eb, "man_bits": mb, "out_fmt": fmt}
    x = _rand(cuda, m, d)
    wqkv = _rand(cuda, d, 3 * d, seed=1, scale=d ** -0.5)
    one = smallfloat_matmul(x, wqkv, **kw)
    three = torch.cat([smallfloat_matmul(x, wqkv[:, i * d:(i + 1) * d], **kw)
                       for i in range(3)], dim=1)
    assert torch.equal(one, three)
    np.testing.assert_allclose(
        one.cpu().numpy(), mm_ops.matmul(x.cpu(), wqkv.cpu(), **kw).numpy(),
        rtol=1e-5, atol=1e-5)
    w1 = _rand(cuda, hidden, d, seed=2, scale=d ** -0.5)
    w2 = _rand(cuda, d, hidden, seed=3, scale=hidden ** -0.5)
    b1, b2 = _rand(cuda, hidden, seed=4), _rand(cuda, d, seed=5)
    layers = [Dense(w1.T, b1, True, fmt), Dense(w2.T, b2, False, fmt)]
    chain = smallfloat_matmul_chain(x, layers, exp_bits=eb, man_bits=mb)
    step = x
    for ly in layers:
        step = smallfloat_matmul_chain(step, [ly], exp_bits=eb, man_bits=mb)
    assert torch.equal(chain, step)
    cpu = [Dense(ly.w.cpu(), ly.b.cpu(), ly.relu, ly.out_fmt)
           for ly in layers]
    np.testing.assert_allclose(
        chain.cpu().numpy(),
        mm_ops.matmul_chain(x.cpu(), cpu, exp_bits=eb,
                            man_bits=mb).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_block_softmax_and_flash_shapes_on_card(cuda):
    """K2 at 16,384 rows of 16 (order 8, fp32 and (5,4) inputs) and K5 at
    1,024 heads of S = 16, D = 16 on the block's strided (B, L, H, dh)
    views, against their plain versions."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_softmax import ops as sm_ops
    b, l, h, dh = 256, FULL[0], FULL[2], FULL[1] // FULL[2]
    s = _rand(cuda, b, h, l, l, scale=4.0)
    for in_fmt in (None, (5, 4)):
        got = sm_ops.softmax(s, taylor_order=8, in_fmt=in_fmt)
        want = sm_ops.softmax(s.cpu(), taylor_order=8, in_fmt=in_fmt)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    qkv = _rand(cuda, b * l, 3 * h * dh, seed=6)
    q, k, v = (qkv[:, i * h * dh:(i + 1) * h * dh].view(b, l, h, dh)
               for i in range(3))
    out = torch.empty(b, l, h, dh, device=cuda)
    fa_ops.attention(q, k, v, causal=False, out=out)
    want = fa_ops.attention(q.cpu(), k.cpu(), v.cpu(), causal=False)
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
