"""Flash attention (K5) of the port and the NLB flash-attention mode of
its nest tier, held against the reference package.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the reference's jnp ``flash_attention_ref`` and its Pallas kernel
in interpret mode over the reference's own sweep (causal, window 32,
soft-cap 10, GQA), at the reference's tolerance, rtol 1e-4 / atol 1e-4.
The NLB flash mode is held against the reference's nest tier with
``nlb_flash=True`` (rtol 1e-4 / atol 1e-5: the same lowering summed in
another order by another framework) and, at atol 5e-2, against the Taylor
functional model it approximates.  The CUDA kernel runs in the
``gpu``-marked tests at the end.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa
    MAX_HEAD_DIM, flash_attention)
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn.module import init_tree  # noqa: E402

#: the reference's own kernel-vs-oracle tolerance
KRTOL = KATOL = 1e-4
#: the NLB flash mode against the reference's (same lowering)
RTOL, ATOL = 1e-4, 1e-5
IMG, BATCH = 9, 4
SWEEP = [(s, h, kv, d, window, cap)
         for s, h, kv, d in [(128, 4, 2, 32), (256, 2, 2, 64), (64, 8, 1, 16)]
         for window, cap in [(None, 0.0), (32, 0.0), (None, 10.0)]]


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    jax = pytest.importorskip("jax")
    import repro.hls
    from repro.core import emit as ref_emit
    from repro.kernels import registry as ref_registry
    from repro.kernels.flash_attention import ops as ref_fa_ops
    from repro.kernels.flash_attention.ref import \
        flash_attention_ref as ref_flash_ref
    from repro.models import braggnn as ref_braggnn
    return types.SimpleNamespace(
        jax=jax, hls=repro.hls, emit=ref_emit, registry=ref_registry,
        fa_ops=ref_fa_ops, flash_ref=ref_flash_ref, braggnn=ref_braggnn)


# ---------------------------------------------------------------------------
# K5's plain version against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,kv,d,window,cap", SWEEP)
def test_plain_flash_attention_matches_reference_sweep(ref, s, h, kv, d,
                                                       window, cap):
    q, k, v = (_rand(s + h + i, 2, s, n, d)
               for i, n in enumerate((h, kv, kv)))
    kw = {"causal": True, "window": window, "logit_cap": cap}
    got = fa_ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw).numpy()
    assert got.shape == (2, s, h, d)
    jnp = ref.jax.numpy
    for use_pallas in (False, True):
        want = ref.fa_ops.attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), use_pallas=use_pallas,
                                    **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=KRTOL,
                                   atol=KATOL)


@pytest.mark.parametrize("s,d", [(64, 24), (32, 40), (64, 128)])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (16, 5.0)])
def test_plain_flash_attention_matches_reference_at_head_dims(ref, s, d,
                                                              window, cap):
    """Head dims the kernel once refused (fault P1): BraggNN(s=3)'s 24, a
    width off every power of two, and the LM configs' 128."""
    q, k, v = (_rand(7 * d + i, 2, s, 2, d) for i in range(3))
    kw = {"causal": True, "window": window, "logit_cap": cap}
    got = fa_ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw).numpy()
    jnp = ref.jax.numpy
    for use_pallas in (False, True):
        want = ref.fa_ops.attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), use_pallas=use_pallas,
                                    **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=KRTOL,
                                   atol=KATOL)


def test_attention_writes_into_a_strided_out():
    """``out`` takes the result in its own layout, as the NLB hands over a
    (B, c2, n) buffer viewed as (B, n, 1, c2)."""
    q, k, v = (torch.from_numpy(_rand(i, 3, 8, 20)).transpose(1, 2)[
        :, :, None, :] for i in range(3))
    buf = torch.empty(3, 8, 20)
    out = fa_ops.attention(q, k, v, causal=False,
                           out=buf.transpose(1, 2)[:, :, None, :])
    assert out.data_ptr() == buf.data_ptr()
    want = flash_attention_ref(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                               causal=False)
    assert torch.equal(buf.transpose(1, 2), want)


@pytest.mark.parametrize("bh,s,causal", [(BATCH, 81, False), (3, 81, True),
                                         (2, 50, True)])
def test_plain_flash_attention_matches_reference_oracle(ref, bh, s, causal):
    """The flattened-heads oracle, at the NLB shape (D = 8) and at
    lengths the reference's kernel would not tile."""
    q, k, v = (_rand(bh * s + i, bh, s, 8) for i in range(3))
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    want = ref.flash_ref(ref.jax.numpy.asarray(q), ref.jax.numpy.asarray(k),
                         ref.jax.numpy.asarray(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KRTOL,
                               atol=KATOL)


def test_flash_attention_registry_entry(ref):
    entry = registry.get("flash_attention")
    assert entry.accelerates == \
        ref.registry.get("flash_attention").accelerates
    assert registry.for_pattern("NonLocalBlock.attention") is entry
    assert entry.fn is fa_ops.attention and entry.kernel is flash_attention


def test_flash_attention_launcher_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(x, x, x)
    assert MAX_HEAD_DIM >= 256
    with pytest.raises(ValueError, match="query heads"):
        fa_ops.attention(torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
                         torch.zeros(1, 4, 2, 8))


# ---------------------------------------------------------------------------
# The NLB flash-attention mode of the nest tier
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def designs(ref):
    m = ref.braggnn.build(1, IMG)
    params = ref.jax.tree_util.tree_map(
        np.asarray, m.init_params(ref.jax.random.PRNGKey(0)))
    rd = ref.hls.Session().compile(m.bind(params))
    pd = hls.Session(device="cpu").compile(braggnn.build(
        1, IMG, params=braggnn.params_from_numpy(params)))
    x = (_rand(0, BATCH, 1, 1, IMG, IMG) * 0.2).astype(np.float32)
    return rd, pd, x


def test_nlb_flash_mode_matches_reference(ref, designs):
    rd, pd, x = designs
    rfn = rd.jax_fn(backend="pallas", nlb_flash=True, use_pallas=False)
    want = rfn(rd.feeds({"input": x}))
    fn = pd.torch_fn(backend="cuda", device="cpu", nlb_flash=True)
    got = fn(x)
    assert fn.plan.kernels == rfn.plan.kernels
    assert fn.plan.kernels["flash_attention"] == 1
    assert "fused_softmax" not in fn.plan.kernels
    assert any("flash-attention throughput mode — true-exp softmax" in n
               for n in fn.plan.notes)
    assert [n for n in fn.plan.notes if "flash" in n] == rfn.plan.notes
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
        # true exp against the order-8 Taylor functional model
        np.testing.assert_allclose(got[k].numpy(), pd.run(x)[k], atol=5e-2)


@pytest.fixture(scope="module")
def designs_s3(ref):
    """BraggNN(s=3, img=9): the NLB's head dim is 24."""
    m = ref.braggnn.build(3, IMG)
    params = ref.jax.tree_util.tree_map(
        np.asarray, m.init_params(ref.jax.random.PRNGKey(0)))
    rd = ref.hls.Session().compile(m.bind(params))
    pd = hls.Session(device="cpu").compile(braggnn.build(
        3, IMG, params=braggnn.params_from_numpy(params)))
    x = (_rand(1, BATCH, 1, 1, IMG, IMG) * 0.2).astype(np.float32)
    return rd, pd, x


def test_nlb_flash_mode_at_s3_matches_reference(ref, designs_s3):
    rd, pd, x = designs_s3
    rfn = rd.jax_fn(backend="pallas", nlb_flash=True, use_pallas=False)
    want = rfn(rd.feeds({"input": x}))
    fn = pd.torch_fn(backend="cuda", device="cpu", nlb_flash=True)
    got = fn(x)
    assert fn.plan.kernels == rfn.plan.kernels
    assert fn.plan.kernels["flash_attention"] == 1
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


def test_nlb_flash_mode_is_fp32_only(ref, designs):
    """With a format the NLB keeps the Taylor softmax, as the reference
    does: the flash kernel has no rounding model."""
    rd, pd, x = designs
    rfn = rd.jax_fn(backend="pallas", nlb_flash=True, use_pallas=False,
                    fmt="5_4")
    fn = pd.torch_fn(backend="cuda", device="cpu", nlb_flash=True,
                     fmt="5_4")
    assert fn.plan.kernels == rfn.plan.kernels
    assert "flash_attention" not in fn.plan.kernels
    assert not fn.plan.notes


def test_serve_nlb_flash_mode_on_cpu(designs):
    _, pd, x = designs
    registry.reset_launch_counts()
    rep = pd.serve([x[:, 0], x[:3, 0]], backend="cuda", device="cpu",
                   cuda_kw={"nlb_flash": True}, collect=True)
    assert "flash_attentionx1" in rep.served
    assert not any(registry.launch_counts().values())   # plain versions
    want = pd.torch_fn(backend="cuda", device="cpu", nlb_flash=True)(x[:3])
    for k in want:
        assert torch.equal(rep.outputs[1][k], want[k])


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,kv,d,window,cap",
                         SWEEP + [(81, 1, 1, 8, None, 10.0),
                                  (100, 2, 1, 64, 32, 0.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_on_card(cuda, s, h, kv, d, window, cap,
                                            causal):
    q, k, v = (torch.from_numpy(_rand(s + h + i, 2, s, n, d)).to(cuda)
               for i, n in enumerate((h, kv, kv)))
    kw = {"causal": causal, "window": window, "logit_cap": cap}
    before = flash_attention.launches
    got = fa_ops.attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = fa_ops.attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=KRTOL,
                               atol=KATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [24, 40, 100, 128, 256])
@pytest.mark.parametrize("window,cap", [(None, 0.0), (32, 0.0), (None, 10.0)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_takes_any_head_dim_and_strided_operands_on_card(
        cuda, d, window, cap, causal):
    """q, k, v and out are (BH, S, D) views of (BH, D, S) buffers, at a
    length no tile divides."""
    bh, s = 4, 100
    q, k, v = (torch.from_numpy(_rand(d + i, bh, d, s)).to(cuda)
               .transpose(1, 2) for i in range(3))
    out = torch.empty(bh, d, s, device=cuda).transpose(1, 2)
    kw = {"causal": causal, "window": window, "logit_cap": cap}
    got = flash_attention(q, k, v, out=out, **kw)
    assert got is out and not q.is_contiguous()
    np.testing.assert_allclose(
        got.cpu().numpy(), flash_attention_ref(q, k, v, **kw).cpu().numpy(),
        rtol=KRTOL, atol=KATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,d", [(1024, 16, 16, 8), (600, 9, 9, 24),
                                         (4, 50, 100, 40), (4, 100, 30, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_packs_short_heads_and_takes_other_key_lengths_on_card(
        cuda, bh, sq, skv, d, causal):
    """Many short heads share a block; the key length may differ from the
    query length."""
    q = torch.from_numpy(_rand(d, bh, sq, d)).to(cuda)
    k, v = (torch.from_numpy(_rand(d + i, bh, skv, d)).to(cuda)
            for i in (1, 2))
    np.testing.assert_allclose(
        flash_attention(q, k, v, causal=causal).cpu().numpy(),
        flash_attention_ref(q, k, v, causal=causal).cpu().numpy(),
        rtol=KRTOL, atol=KATOL)


@pytest.mark.gpu
def test_flash_kernel_refuses_a_head_dim_over_its_limit_on_card(cuda):
    x = torch.zeros(1, 4, MAX_HEAD_DIM + 1, device=cuda)
    with pytest.raises(ValueError, match=f"1 to {MAX_HEAD_DIM}"):
        flash_attention(x, x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [256, 100])
def test_flash_kernel_at_the_nlb_shape_on_card(cuda, b):
    q, k, v = (torch.from_numpy(_rand(b + i, b, 81, 8)).to(cuda)
               for i in range(3))
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=KRTOL, atol=KATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 3])
def test_nlb_flash_mode_on_card_matches_cpu(cuda, s):
    """s=3: the NLB's head dim is 24 (fault P1)."""
    m = braggnn.build(s, IMG)
    d = hls.compile(m.bind(init_tree(m.specs(),
                                     torch.Generator().manual_seed(0))))
    x = (_rand(0, BATCH, 1, IMG, IMG) * 0.2).astype(np.float32)
    registry.reset_launch_counts()
    got = d.torch_fn(backend="cuda", nlb_flash=True)(x)
    counts = registry.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["smallfloat_matmul"] == 1
    want = d.torch_fn(backend="cuda", device="cpu", nlb_flash=True)(x)
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL)
