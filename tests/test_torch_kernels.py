"""The port's kernels: plain PyTorch versions against the reference's
Pallas kernels, the wrappers' routing, the registry and the build.

On the CPU every wrapper takes its kernel's plain PyTorch version, so the
plain versions are what is held against the reference here:

* at fp32, against the reference kernel run through its registry wrapper
  with ``use_pallas=True, interpret=True`` (rtol 1e-5 / atol 1e-5: the two
  frameworks sum in another order);
* at a (wE, wF) format, against the reference's jnp oracle fed operands
  pre-quantised with ``quantize_np`` and ``fmt=None``, which keeps the
  reference's jnp quantiser (fault R1 in ROADMAP.md) out of the check.

The CUDA kernels themselves run only on a card: those tests carry the
``gpu`` marker and skip here.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.precision import FloatFormat, quantize_np  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels._checks import fmt_args  # noqa: E402
from repro_torch.kernels.conv2d_vmem import ops as conv_ops  # noqa: E402
from repro_torch.kernels.conv2d_vmem.conv2d_vmem import \
    conv2d_vmem  # noqa: E402
from repro_torch.kernels.conv2d_vmem.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.fused_softmax import ops as sm_ops  # noqa: E402
from repro_torch.kernels.fused_softmax.fused_softmax import \
    fused_softmax  # noqa: E402
from repro_torch.kernels.fused_softmax.ref import \
    fused_softmax_ref  # noqa: E402
from repro_torch.kernels.smallfloat_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.smallfloat_matmul.ref import \
    smallfloat_matmul_ref  # noqa: E402
from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import \
    smallfloat_matmul  # noqa: E402

#: plain version vs reference kernel: same operands, another summation order
RTOL = ATOL = 1e-5
FMTS = [(5, 4), (5, 3), (5, 11)]


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qnp(a, fmt):
    # held bitwise equal to the reference's in test_torch_precision.py
    return quantize_np(a, FloatFormat(*fmt))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def ref():
    """The reference package's kernel registry and ``jax.numpy``."""
    jax = pytest.importorskip("jax")
    from repro.kernels import registry as ref_registry
    return ref_registry, jax.numpy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# smallfloat_matmul (K3)
# ---------------------------------------------------------------------------

MM_SHAPES = [(128, 128, 128), (256, 384, 128), (64, 512, 256),
             # BraggNN(s=1, img=11)'s dense layers at a batch of 4
             (4, 50, 16), (4, 16, 8), (4, 8, 4), (4, 4, 2)]


def _mm_operands(m, k, n, seed):
    # w ~ N(0, 1/k) keeps the outputs O(1) at every depth
    return _rand(seed, m, k), _rand(seed + 1, k, n, scale=k ** -0.5)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_matches_reference_kernel_fp32(ref, m, k, n,
                                                     dtype):
    ref_registry, jnp = ref
    x, w = _mm_operands(m, k, n, m + k + n)
    b = _rand(7, n)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    want = ref_registry.get("smallfloat_matmul").fn(
        jx, jw, jnp.asarray(b), exp_bits=None, man_bits=None,
        fuse_relu=True, use_pallas=True, interpret=True)
    tdt = getattr(torch, dtype)
    got = smallfloat_matmul_ref(_t(x).to(tdt), _t(w).to(tdt), _t(b),
                                exp_bits=None, man_bits=None,
                                fuse_relu=True)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_matmul_plain_matches_oracle_on_prequantised_operands(ref, m, k, n,
                                                              fmt):
    ref_registry, jnp = ref
    x, w = _mm_operands(m, k, n, 3 * m + n)
    b = _rand(8, n)
    want = ref_registry.get("smallfloat_matmul").oracle(
        jnp.asarray(_qnp(x, fmt)), jnp.asarray(_qnp(w, fmt)),
        jnp.asarray(b), exp_bits=None, fuse_relu=True)
    got = smallfloat_matmul_ref(_t(x), _t(w), _t(b), exp_bits=fmt[0],
                                man_bits=fmt[1], fuse_relu=True)
    _close(got, want)


@pytest.mark.parametrize("m,k,n", MM_SHAPES[3:])
@pytest.mark.parametrize("fmt", FMTS)
def test_matmul_plain_rounds_its_result_like_the_reference(ref, m, k, n,
                                                           fmt):
    """``out_fmt`` is the nest tier's rounding of the kernel result."""
    ref_registry, jnp = ref
    x, w = _mm_operands(m, k, n, 5 * m + n)
    b = _rand(9, n)
    want = _qnp(np.asarray(ref_registry.get("smallfloat_matmul").oracle(
        jnp.asarray(_qnp(x, fmt)), jnp.asarray(_qnp(w, fmt)),
        jnp.asarray(b), exp_bits=None, fuse_relu=True)), fmt)
    got = mm_ops.matmul(_t(x), _t(w), _t(b), exp_bits=fmt[0],
                        man_bits=fmt[1], fuse_relu=True, out_fmt=fmt)
    _close(got, want)


def test_matmul_plain_takes_a_transposed_weight_view():
    """The nest tier hands the kernel ``W.T`` as a strided view."""
    x, w = _mm_operands(8, 50, 16, 1)
    wt = _t(np.ascontiguousarray(w.T)).T
    assert not wt.is_contiguous()
    _close(mm_ops.matmul(_t(x), wt, exp_bits=5, man_bits=4),
           smallfloat_matmul_ref(_t(x), _t(w)))


# ---------------------------------------------------------------------------
# conv2d_vmem (K1)
# ---------------------------------------------------------------------------

#: (batch, cin, cout, img, k, bias, relu): the sweep of tests/test_kernels.py
#: and every BraggNN(s=1) conv of the nest tier at img 9 and 11
CONV_SHAPES = [(8, 1, 16, 11, 3, True, False), (4, 3, 8, 9, 3, True, False),
               (2, 16, 8, 9, 1, True, False)]
for _img in (9, 11):
    _h = _img - 2
    CONV_SHAPES += [(4, 1, 16, _img, 3, True, False),     # conv1
                    (4, 16, 8, _h, 1, False, False),      # nlb theta/phi/g
                    (4, 8, 16, _h, 1, False, False),      # nlb out
                    (4, 16, 8, _h, 3, True, True),        # conv2a + ReLU
                    (4, 8, 2, _h - 2, 3, True, True)]     # conv2b + ReLU


@pytest.mark.parametrize("b,cin,cout,img,kk,bias,relu", CONV_SHAPES)
@pytest.mark.parametrize("fmt", [None, (5, 4)])
def test_conv_plain_matches_reference(ref, b, cin, cout, img, kk, bias,
                                      relu, fmt):
    ref_registry, jnp = ref
    seed = b * img + cin
    x = _rand(seed, b, cin, img, img)
    w = _rand(seed + 1, cout, cin, kk, kk, scale=(cin * kk * kk) ** -0.5)
    bb = _rand(seed + 2, cout) if bias else None
    if fmt is None:
        want = ref_registry.get("conv2d_vmem").fn(
            jnp.asarray(x), jnp.asarray(w),
            None if bb is None else jnp.asarray(bb), fuse_relu=relu,
            use_pallas=True, interpret=True)
    else:
        want = ref_registry.get("conv2d_vmem").oracle(
            jnp.asarray(_qnp(x, fmt)), jnp.asarray(_qnp(w, fmt)),
            None if bb is None else jnp.asarray(bb), fuse_relu=relu)
    got = conv_ops.conv2d(_t(x), _t(w), None if bb is None else _t(bb),
                          fmt=fmt, fuse_relu=relu)
    _close(got, want)


@pytest.mark.parametrize("fmt", [None, (5, 4), (5, 3)])
def test_conv_plain_epilogue_rounds_and_adds_the_residual(ref, fmt):
    """The NLB out-projection: round the conv result, add the block's
    input, round the sum — the reference's ``q(x + q(conv(y)))``."""
    ref_registry, jnp = ref
    y = _rand(11, 4, 8, 7, 7)
    w = _rand(12, 16, 8, 1, 1, scale=8 ** -0.5)
    res = _rand(13, 4, 16, 7, 7)
    q = (lambda a: _qnp(a, fmt)) if fmt else (lambda a: a)
    z = ref_registry.get("conv2d_vmem").oracle(jnp.asarray(q(y)),
                                               jnp.asarray(q(w)), None)
    want = q(res + q(np.asarray(z)))
    got = conv_ops.conv2d(_t(y), _t(w), fmt=fmt, out_fmt=fmt,
                          residual=_t(res))
    _close(got, want)


# ---------------------------------------------------------------------------
# fused_softmax (K2)
# ---------------------------------------------------------------------------

#: the sweep of tests/test_kernels.py, then the NLB softmax of
#: BraggNN(s=1) at img 9 (4 samples) and img 11 (3 samples: the reference
#: kernel tiles 256 rows, so B*81 rows must divide evenly)
SM_SHAPES = [(256, 64, 3.0), (128, 200, 3.0), (512, 32, 3.0),
             (4 * 49, 49, 1.0), (3 * 81, 81, 1.0)]


@pytest.mark.parametrize("rows,cols,scale", SM_SHAPES)
@pytest.mark.parametrize("taylor", [0, 8])
def test_softmax_plain_matches_reference_kernel(ref, rows, cols, scale,
                                                taylor):
    ref_registry, jnp = ref
    x = _rand(rows + cols, rows, cols, scale=scale)
    want = ref_registry.get("fused_softmax").fn(
        jnp.asarray(x), taylor_order=taylor, use_pallas=True,
        interpret=True)
    got = sm_ops.softmax(_t(x), taylor_order=taylor)
    _close(got, want)
    if taylor == 0:
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("fmt", [(5, 4), (5, 3)])
def test_softmax_plain_rounds_its_input_like_the_reference(ref, fmt):
    """``in_fmt`` is the nest tier's rounding of the NLB scores."""
    ref_registry, jnp = ref
    x = _rand(21, 4 * 49, 49, scale=3.0)
    want = ref_registry.get("fused_softmax").fn(
        jnp.asarray(_qnp(x, fmt)), taylor_order=8, use_pallas=True,
        interpret=True)
    _close(sm_ops.softmax(_t(x), taylor_order=8, in_fmt=fmt), want)


def test_softmax_wrapper_flattens_leading_axes():
    x = _t(_rand(0, 2, 3, 49, 49))
    got = sm_ops.softmax(x, taylor_order=8)
    assert got.shape == x.shape
    _close(got, fused_softmax_ref(x.reshape(-1, 49),
                                  taylor_order=8).reshape(x.shape))


# ---------------------------------------------------------------------------
# Wrappers: the plain version only for CPU tensors, the kernel or an error
# for everything else
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    registry.reset_launch_counts()
    x = _t(_rand(0, 2, 1, 11, 11))
    w = _t(_rand(1, 16, 1, 3, 3))
    conv_ops.conv2d(x, w)
    sm_ops.softmax(_t(_rand(2, 8, 8)))
    mm_ops.matmul(_t(_rand(3, 4, 8)), _t(_rand(4, 8, 2)))
    assert registry.launch_counts() == {"conv2d_vmem": 0,
                                        "fused_softmax": 0,
                                        "smallfloat_matmul": 0}


@pytest.mark.parametrize("launch", [
    lambda x: conv2d_vmem(x.reshape(1, 1, 4, 4), x.reshape(1, 1, 4, 4)),
    lambda x: fused_softmax(x.reshape(4, 4)),
    lambda x: smallfloat_matmul(x.reshape(4, 4), x.reshape(4, 4)),
])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(torch.zeros(16))


def test_format_arguments_are_checked():
    assert fmt_args(None) == (-1, -1)
    assert fmt_args((5, 4)) == (5, 4)
    for bad in [(1, 4), (9, 4), (5, 23)]:
        with pytest.raises(ValueError, match="outside the kernels' range"):
            fmt_args(bad)


# ---------------------------------------------------------------------------
# Registry: the reference's names and patterns for the ported kernels
# ---------------------------------------------------------------------------

def test_registry_holds_the_three_ported_kernels(ref):
    ref_registry, _ = ref
    assert registry.names() == ["conv2d_vmem", "fused_softmax",
                                "smallfloat_matmul"]
    for name in registry.names():
        assert registry.get(name).accelerates == \
            ref_registry.get(name).accelerates


@pytest.mark.parametrize("pattern,name", [
    ("Conv2d", "conv2d_vmem"), ("nlb.conv1x1", "conv2d_vmem"),
    ("Linear", "smallfloat_matmul"), ("Softmax", "fused_softmax"),
    ("nlb.soft", "fused_softmax"), ("NonLocalBlock.attention", None),
])
def test_registry_pattern_table(pattern, name):
    entry = registry.for_pattern(pattern)
    assert (entry.name if entry else None) == name


def test_registry_rejects_duplicates_and_unknown():
    with pytest.raises(ValueError, match="already registered"):
        registry.register(registry.get("conv2d_vmem"))
    with pytest.raises(KeyError, match="no kernel"):
        registry.get("flash_attention")


# ---------------------------------------------------------------------------
# Build: sources, their notes, and the build key
# ---------------------------------------------------------------------------

def test_every_kernel_source_names_the_tpu_kernel_it_replaces():
    names = {p.stem for p in build.sources()}
    assert {"conv2d_vmem", "fused_softmax", "smallfloat_matmul",
            "quantize", "errors"} <= names
    for name in registry.names():
        text = (build.CSRC / f"{name}.cu").read_text()
        head = text[:text.index("#include")]
        assert "Replaces the TPU kernel" in head
        assert f"src/repro/kernels/{name}/{name}.py" in head
        assert "What bounds it on an H100" in head
    entry_points = " ".join(p.read_text() for p in build.sources())
    for fn in build.SIGNATURES:
        assert f'extern "C" int {fn}(' in entry_points


def test_build_key_follows_the_sources():
    key = build.source_hash()
    assert len(key) == 16 and key == build.source_hash()
    assert "-gencode" in build.FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS


def test_build_without_nvcc_raises():
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    if (build.BUILD_DIR / f"librepro_torch_{build.source_hash()}.so") \
            .exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b", [256, 100, 3])
@pytest.mark.parametrize("fmt", [None, (5, 4)])
def test_conv_kernel_matches_plain_on_card(cuda, b, fmt):
    for _, cin, cout, img, kk, bias, relu in CONV_SHAPES[3:8]:
        x = _t(_rand(b, b, cin, img, img)).to(cuda)
        w = _t(_rand(1, cout, cin, kk, kk)).to(cuda)
        bb = _t(_rand(2, cout)).to(cuda) if bias else None
        before = conv2d_vmem.launches
        got = conv2d_vmem(x, w, bb, fmt=fmt, fuse_relu=relu)
        assert conv2d_vmem.launches == before + 1
        _close(got.cpu(), conv2d_ref(x, w, bb, fmt=fmt,
                                     fuse_relu=relu).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", MM_SHAPES + [(100, 50, 16), (33, 70, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", [None, (5, 4)])
def test_matmul_kernel_matches_plain_on_card(cuda, m, k, n, dtype, fmt):
    x, w = _mm_operands(m, k, n, m)
    tdt = getattr(torch, dtype)
    xd = _t(x).to(cuda, tdt)
    wd = _t(np.ascontiguousarray(w.T)).to(cuda, tdt).T
    bd = _t(_rand(3, n)).to(cuda)
    eb, mb = fmt if fmt else (None, None)
    got = smallfloat_matmul(xd, wd, bd, exp_bits=eb, man_bits=mb,
                            fuse_relu=True)
    want = smallfloat_matmul_ref(xd, wd, bd, exp_bits=eb, man_bits=mb,
                                 fuse_relu=True)
    _close(got.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,scale", SM_SHAPES + [(256 * 81, 81, 1.0),
                                                         (7, 1000, 1.0)])
@pytest.mark.parametrize("taylor", [0, 8])
def test_softmax_kernel_matches_plain_on_card(cuda, rows, cols, scale,
                                              taylor):
    x = _t(_rand(rows, rows, cols, scale=scale)).to(cuda)
    _close(fused_softmax(x, taylor_order=taylor).cpu(),
           fused_softmax_ref(x, taylor_order=taylor).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("b", [256, 100])
@pytest.mark.parametrize("fmt", [None, (5, 4)])
def test_conv_kernel_epilogue_matches_plain_on_card(cuda, b, fmt):
    y = _t(_rand(b, b, 8, 9, 9)).to(cuda)
    w = _t(_rand(1, 16, 8, 1, 1)).to(cuda)
    res = _t(_rand(2, b, 16, 9, 9)).to(cuda)
    kw = {"fmt": fmt, "out_fmt": fmt, "residual": res}
    _close(conv2d_vmem(y, w, **kw).cpu(), conv2d_ref(y, w, **kw).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", MM_SHAPES[3:] + [(100, 50, 16)])
def test_matmul_kernel_rounds_its_result_on_card(cuda, m, k, n):
    x, w = _mm_operands(m, k, n, m)
    xd, wd = _t(x).to(cuda), _t(w).to(cuda)
    bd = _t(_rand(3, n)).to(cuda)
    kw = {"exp_bits": 5, "man_bits": 4, "fuse_relu": True,
          "out_fmt": (5, 4)}
    _close(smallfloat_matmul(xd, wd, bd, **kw).cpu(),
           smallfloat_matmul_ref(xd, wd, bd, **kw).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [256 * 81, 100 * 81])
def test_softmax_kernel_rounds_its_input_on_card(cuda, rows):
    x = _t(_rand(rows, rows, 81, scale=4.0)).to(cuda)
    kw = {"taylor_order": 8, "in_fmt": (5, 4)}
    _close(fused_softmax(x, **kw).cpu(), fused_softmax_ref(x, **kw).cpu())
