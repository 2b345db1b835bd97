"""The port's training path held against the reference package.

``ste_quantize``, ``quantize_tree``, the Fig. 7 exponent histogram, AdamW,
int8 error-feedback compression, BraggNN's gradients and its first
training steps, each fed the same numpy inputs made from a seed in both
packages.  Tolerances, stated per test:

* the quantisers: bitwise (against ``quantize_np``, not the reference's jnp
  quantiser, which is off the lattice on about 2.8% of inputs: fault R1 in
  ROADMAP.md);
* AdamW: params, mu and nu rtol 1e-5 / atol 1e-7, ``lr`` and ``grad_norm``
  rtol 1e-6 (``b ** step`` and the cosine are fp32 in both, and may differ
  by an ulp);
* BraggNN's gradients: rtol 1e-4 / atol 1e-6 (XLA and ATen sum the conv
  gradients in different orders); 20 training steps: losses rtol 2e-2
  (Adam's normalised update amplifies those differences where a gradient
  is near 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.precision import (FORMATS, FP_5_4,  # noqa: E402
                                        exponent_histogram, quantize,
                                        quantize_np, quantize_tree,
                                        required_exponent_bits, ste_quantize)
from repro_torch.kernels.quantize import probe_values  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn.module import (init_tree, map_tree,  # noqa: E402
                                   params_from_numpy, tree_flatten,
                                   tree_leaves, tree_unflatten)
from repro_torch.optim import adamw, compress  # noqa: E402

IMG = 11
#: the recipe of tests/test_braggnn_paper.py's convergence test
RECIPE = dict(peak_lr=3e-2, warmup_steps=20, total_steps=2000,
              weight_decay=0.0)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def np_peaks(rng: np.random.Generator, n: int, img: int = IMG):
    """Synthetic Bragg peaks drawn with numpy (the same blobs as both
    packages' ``synthetic_peaks``), so both packages get one batch."""
    centers = rng.uniform(3.0, img - 3.0, (n, 2))
    sigma = rng.uniform(0.8, 1.6, (n, 1, 1))
    yy, xx = np.mgrid[0:img, 0:img]
    blob = np.exp(-(((yy[None] - centers[:, 0, None, None]) ** 2
                     + (xx[None] - centers[:, 1, None, None]) ** 2)
                    / (2 * sigma ** 2)))
    imgs = blob + 0.02 * rng.standard_normal(blob.shape)
    return (imgs[:, None].astype(np.float32),
            (centers / img).astype(np.float32))


@pytest.fixture(scope="module")
def ref():
    """The reference package's training modules (they import JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import precision
    from repro.models import braggnn as ref_braggnn
    from repro.nn import module
    from repro.optim import adamw as ref_adamw
    from repro.optim import compress as ref_compress
    import types
    return types.SimpleNamespace(jax=jax, jnp=jnp, precision=precision,
                                 braggnn=ref_braggnn, module=module,
                                 adamw=ref_adamw, compress=ref_compress)


@pytest.fixture(scope="module")
def np_params(ref):
    """BraggNN(s=1, img=11) weights from the reference's init, as numpy."""
    p = ref.module.init_tree(ref.braggnn.specs(1, IMG), ref.jax.random.key(0))
    return ref.jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# precision: ste_quantize, quantize_tree, Fig. 7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(FORMATS))
def test_ste_quantize_forward_bitwise_equals_quantize_np(key):
    fmt = FORMATS[key]
    x = probe_values(fmt, 1 << 16, seed=21)
    got = ste_quantize(torch.from_numpy(x), fmt.exp_bits, fmt.man_bits)
    with np.errstate(over="ignore"):
        want = quantize_np(x, fmt)
    np.testing.assert_array_equal(_bits(_np(got)), _bits(want))


def test_ste_gradient_equals_reference(ref):
    """The reference's test_ste_gradient_is_identity, both packages."""
    x = np.linspace(-2.0, 2.0, 16, dtype=np.float32)
    want = ref.jax.grad(lambda v: ref.jnp.sum(
        ref.precision.ste_quantize(v, 5, 4) * 3.0))(ref.jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(torch.sum(ste_quantize(xt, 5, 4) * 3.0), xt)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), 3.0)


@pytest.mark.parametrize("key", sorted(FORMATS))
def test_quantize_tree_bitwise_per_leaf(key):
    fmt = FORMATS[key]
    a, b = probe_values(fmt, 4096, seed=22), probe_values(fmt, 100, seed=23)
    tree = {"w": torch.from_numpy(a.reshape(64, 64)),
            "inner": {"b": torch.from_numpy(b)},
            "count": torch.arange(5, dtype=torch.int32)}
    with np.errstate(over="ignore"):
        out = quantize_tree(tree, fmt)
        np.testing.assert_array_equal(_bits(_np(out["w"])).ravel(),
                                      _bits(quantize_np(a, fmt)))
        np.testing.assert_array_equal(_bits(_np(out["inner"]["b"])),
                                      _bits(quantize_np(b, fmt)))
    assert torch.equal(out["count"], tree["count"])


def _hist_trees(np_params):
    rng = np.random.default_rng(24)
    spread = rng.standard_normal(5000).astype(np.float32) * np.exp2(
        rng.uniform(-20, 10, 5000)).astype(np.float32)
    spread[:7] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 3e38]
    return [{"a": np.asarray([0.5, 0.25, 1.0, 2.0], np.float32)},
            {"a": np.asarray([2.0 ** -14, 2.0 ** 15], np.float32)},
            np_params, {"x": spread, "y": [spread[::3], spread[1::7]]}]


def test_exponent_histogram_and_required_bits_equal_reference(ref,
                                                              np_params):
    for tree in _hist_trees(np_params):
        port_tree = map_tree(torch.tensor, tree) if "y" not in tree \
            else tree
        want = ref.precision.exponent_histogram(tree)
        got = exponent_histogram(port_tree)
        assert got == want
        for cov in (1.0, 0.999, 0.9):
            assert required_exponent_bits(got, cov) == \
                ref.precision.required_exponent_bits(want, cov)
    # the reference test's contract
    hist = exponent_histogram({"a": torch.tensor([0.5, 0.25, 1.0, 2.0])})
    assert hist == {-1: 1, -2: 1, 0: 1, 1: 1}
    assert required_exponent_bits(hist) <= 3
    assert required_exponent_bits(exponent_histogram(
        {"a": torch.tensor([2.0 ** -14, 2.0 ** 15])})) == 5
    assert required_exponent_bits({}) == 1


# ---------------------------------------------------------------------------
# AdamW and compression
# ---------------------------------------------------------------------------

def _grads(rng, tree, scale):
    return map_tree(lambda p: (rng.standard_normal(p.shape) * scale)
                    .astype(np.float32), tree)


def _assert_tree_close(got, want, rtol, atol):
    got_l, want_l = tree_leaves(got), tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


def test_apply_updates_equals_reference_after_1_and_20_steps(ref,
                                                             np_params):
    """Params, mu and nu rtol 1e-5 / atol 1e-7; lr and grad_norm rtol
    1e-6.  Warm-up, the cosine, weight decay and clipping (norms of 0.3 to
    30 against clip 1.0) all run."""
    cfg = dict(peak_lr=3e-2, warmup_steps=5, total_steps=30,
               weight_decay=0.1, clip_norm=1.0)
    r_cfg, p_cfg = ref.adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(25)
    r_p = ref.jax.tree_util.tree_map(ref.jnp.asarray, np_params)
    p_p = params_from_numpy(np_params)
    r_s, p_s = ref.adamw.init_state(r_p), adamw.init_state(p_p)
    r_apply = ref.jax.jit(lambda p, g, s: ref.adamw.apply_updates(
        r_cfg, p, g, s))
    before = [_np(t).copy() for t in tree_leaves(p_p)]
    for i in range(20):
        g = _grads(rng, np_params, scale=10.0 ** rng.uniform(-2.5, -0.5))
        r_p, r_s, r_m = r_apply(
            r_p, ref.jax.tree_util.tree_map(ref.jnp.asarray, g), r_s)
        new_p, p_s, p_m = adamw.apply_updates(p_cfg, p_p,
                                              params_from_numpy(g), p_s)
        if i == 0:
            # in place: the given tensors are returned, written
            assert all(a is b for a, b in zip(tree_leaves(new_p),
                                              tree_leaves(p_p)))
            assert not any(np.array_equal(_np(t), b) for t, b in zip(
                tree_leaves(p_p), before))
        p_p = new_p
        if i in (0, 19):
            _assert_tree_close(p_p, r_p, 1e-5, 1e-7)
            _assert_tree_close(p_s["mu"], r_s["mu"], 1e-5, 1e-7)
            _assert_tree_close(p_s["nu"], r_s["nu"], 1e-5, 1e-7)
            assert int(p_s["step"]) == int(r_s["step"]) == i + 1
            assert p_s["step"].dtype == torch.int32
            for k in ("lr", "grad_norm"):
                np.testing.assert_allclose(float(p_m[k]), float(r_m[k]),
                                           rtol=1e-6)


@pytest.mark.parametrize("cfg", [RECIPE, {}], ids=["recipe", "default"])
def test_cosine_lr_equals_reference_over_2000_steps(ref, cfg):
    """rtol 1e-6; atol four fp32 ulps of cos near -1 (2^-24 each) scaled
    by the schedule's 0.5 (peak - end): near the end of the cosine,
    1 + cos cancels, and jnp's and torch's fp32 cos may differ by an ulp
    there."""
    steps = np.arange(0, 2001, dtype=np.int32)
    want = np.asarray(ref.adamw.cosine_lr(ref.adamw.AdamWConfig(**cfg),
                                          ref.jnp.asarray(steps)))
    p_cfg = adamw.AdamWConfig(**cfg)
    got = adamw.cosine_lr(p_cfg, torch.from_numpy(steps)).numpy()
    atol = 0.5 * (p_cfg.peak_lr - p_cfg.end_lr) * 4 * 2.0 ** -24
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    assert got[0] == 0.0 and got.dtype == np.float32


def test_clip_by_global_norm_scales_to_the_bound():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((3,), 4.0)}
    clipped, gn = adamw.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(gn), np.sqrt(4 * 9 + 3 * 16), rtol=1e-6)
    total = np.sqrt(sum(float((t ** 2).sum()) for t in tree_leaves(clipped)))
    np.testing.assert_allclose(total, 1.0, rtol=1e-6)
    small, _ = adamw.clip_by_global_norm(g, 100.0)
    assert torch.equal(small["a"], g["a"])


def test_compress_with_feedback_equals_reference(ref, np_params):
    """Three steps with the error carried: the int8 payload equal, the
    dequantised gradients and the carried error within rtol 1e-6."""
    rng = np.random.default_rng(26)
    r_e = ref.compress.init_error_state(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, np_params))
    p_e = compress.init_error_state(params_from_numpy(np_params))
    for _ in range(3):
        g = _grads(rng, np_params, scale=0.1)
        r_g = ref.jax.tree_util.tree_map(ref.jnp.asarray, g)
        p_g = params_from_numpy(g)
        for rg, re_, pg, pe in zip(tree_leaves(r_g), tree_leaves(r_e),
                                   tree_leaves(p_g), tree_leaves(p_e)):
            rq, rs = ref.compress.quantize_int8(rg + re_)
            pq, ps = compress.quantize_int8(pg + pe)
            assert pq.dtype == torch.int8
            np.testing.assert_array_equal(_np(pq), np.asarray(rq))
            np.testing.assert_allclose(float(ps), float(rs), rtol=1e-6)
        r_d, r_e = ref.compress.compress_with_feedback(r_g, r_e)
        p_d, p_e = compress.compress_with_feedback(p_g, p_e)
        _assert_tree_close(p_d, r_d, 1e-6, 0.0)
        _assert_tree_close(p_e, r_e, 1e-6, 0.0)


def test_dequantize_int8_round_trip():
    x = torch.linspace(-3.0, 3.0, 101)
    q, s = compress.quantize_int8(x)
    assert int(q.abs().max()) == 127
    assert float((compress.dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) / 2 + 1e-7


# ---------------------------------------------------------------------------
# BraggNN: gradients and training
# ---------------------------------------------------------------------------

def _ref_loss(ref):
    def loss(p, x, y):
        return ref.jnp.mean((ref.braggnn.forward(p, x) - y * 10.0) ** 2)
    return loss


def test_braggnn_gradients_equal_reference(ref, np_params):
    """Loss rtol 1e-5; every gradient rtol 1e-4 / atol 1e-6."""
    x, y = np_peaks(np.random.default_rng(27), 16)
    r_loss, r_g = ref.jax.jit(ref.jax.value_and_grad(_ref_loss(ref)))(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, np_params),
        ref.jnp.asarray(x), ref.jnp.asarray(y))
    leaves = [t.requires_grad_() for t in
              tree_leaves(params_from_numpy(np_params))]
    treedef = tree_flatten(np_params)[1]
    loss = braggnn.loss_fn(tree_unflatten(treedef, leaves),
                                 torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(r_loss),
                               rtol=1e-5)
    want = ref.jax.tree_util.tree_leaves(r_g)
    assert len(grads) == len(want) == 18
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_twenty_training_steps_follow_reference(ref, np_params):
    """The convergence test's recipe from the same weights and batches:
    losses rtol 2e-2 over the first 20 steps."""
    rng = np.random.default_rng(28)
    data = [np_peaks(rng, 64) for _ in range(20)]
    r_cfg = ref.adamw.AdamWConfig(**RECIPE)
    loss_fn = _ref_loss(ref)

    @ref.jax.jit
    def r_step(p, s, x, y):
        loss, g = ref.jax.value_and_grad(loss_fn)(p, x, y)
        p2, s2, _ = ref.adamw.apply_updates(r_cfg, p, g, s)
        return p2, s2, loss

    r_p = ref.jax.tree_util.tree_map(ref.jnp.asarray, np_params)
    r_s = ref.adamw.init_state(r_p)
    p_p = params_from_numpy(np_params)
    p_s = adamw.init_state(p_p)
    step = braggnn.make_step(adamw.AdamWConfig(**RECIPE))
    want, got = [], []
    for x, y in data:
        r_p, r_s, r_l = r_step(r_p, r_s, x, y)
        p_p, p_s, p_l = step(p_p, p_s, torch.from_numpy(x),
                             torch.from_numpy(y))
        want.append(float(r_l))
        got.append(float(p_l))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0] / 2          # the steps do train


def test_port_training_converges():
    """The bar of the reference's test_braggnn_training_converges, on the
    port alone (its own seeded init and peaks): 200 AdamW steps at batch
    64 drop the held-out loss by more than 5x, below 1.0."""
    params = init_tree(braggnn.specs(1, IMG), torch.Generator().manual_seed(0))
    state = adamw.init_state(params)
    step = braggnn.make_step(adamw.AdamWConfig(**RECIPE))
    eval_x, eval_y = braggnn.synthetic_peaks(
        256, IMG, torch.Generator().manual_seed(99))
    with torch.no_grad():
        first = float(braggnn.loss_fn(params, eval_x, eval_y))
    gen = torch.Generator().manual_seed(1)
    for _ in range(200):
        x, y = braggnn.synthetic_peaks(64, IMG, gen)
        params, state, _ = step(params, state, x, y)
    with torch.no_grad():
        last = float(braggnn.loss_fn(params, eval_x, eval_y))
    assert last < first / 5, (first, last)
    assert last < 1.0, last


def test_make_step_leaves_its_inputs_alone():
    params = init_tree(braggnn.specs(1, IMG), torch.Generator().manual_seed(1))
    state = adamw.init_state(params)
    snap = [t.clone() for t in tree_leaves((params, state))]
    x, y = braggnn.synthetic_peaks(8, IMG, torch.Generator().manual_seed(2))
    p2, s2, loss = braggnn.make_step(adamw.AdamWConfig())(
        params, state, x, y)
    for t, c in zip(tree_leaves((params, state)), snap):
        assert torch.equal(t, c)
    assert int(s2["step"]) == 1 and loss.dim() == 0
    assert not any(t.requires_grad for t in tree_leaves(p2))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(FORMATS))
def test_ste_quantize_launches_the_device_quantiser(cuda, key):
    """Bitwise against quantize_np on 1M probe values; the gradient 3."""
    fmt = FORMATS[key]
    x = probe_values(fmt, 1 << 20, seed=29)
    xd = torch.from_numpy(x).to(cuda).requires_grad_()
    out = ste_quantize(xd, fmt.exp_bits, fmt.man_bits)
    assert out.is_cuda
    with np.errstate(over="ignore"):
        want = quantize_np(x, fmt)
    np.testing.assert_array_equal(_bits(_np(out)), _bits(want))
    (g,) = torch.autograd.grad(torch.sum(3.0 * out), xd)
    assert bool((g == 3.0).all())
    # a strided view goes through a contiguous copy
    view = torch.from_numpy(x[:4096]).to(cuda).reshape(64, 64).t()
    np.testing.assert_array_equal(
        _bits(_np(ste_quantize(view, 5, 4))),
        _bits(_np(quantize(view, FP_5_4))))


@pytest.mark.gpu
def test_train_step_on_the_card_equals_its_cpu_run(cuda):
    """Loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (cuDNN sums in
    another order than ATen on the CPU, TF32 off); the AdamW update of the
    same gradients rtol 1e-5 / atol 1e-7."""
    params = init_tree(braggnn.specs(1, IMG), torch.Generator().manual_seed(0))
    x, y = braggnn.synthetic_peaks(64, IMG, torch.Generator().manual_seed(1))
    leaves, treedef = tree_flatten(params)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        live = [t.to(dev).requires_grad_() for t in leaves]
        loss = braggnn.loss_fn(tree_unflatten(treedef, live),
                                     x.to(dev), y.to(dev))
        out[dev.type] = (float(loss.detach()),
                         torch.autograd.grad(loss, live))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, c in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(_np(g), _np(c), rtol=1e-4, atol=1e-6)
    cfg = adamw.AdamWConfig(**RECIPE)
    grads = tree_unflatten(treedef, list(out["cpu"][1]))
    new = {}
    for dev in (torch.device("cpu"), cuda):
        # copies: the update writes the parameters in place
        p = map_tree(lambda t: t.detach().to(dev, copy=True), params)
        g = map_tree(lambda t: t.to(dev), grads)
        new[dev.type] = adamw.apply_updates(cfg, p, g, adamw.init_state(p))
    _assert_tree_close(new["cuda"][0], map_tree(_np, new["cpu"][0]), 1e-5,
                       1e-7)


@pytest.mark.gpu
def test_graphed_step_equals_the_eager_step_on_the_card(cuda, monkeypatch):
    """Five AdamW steps at batch 64 through the step's captured graph (the
    first call captures, the rest replay) and through ``step.eager``, under
    deterministic cuDNN and cuBLAS (Hopper's default cuBLAS workspace,
    named so that PyTorch allows it): the same losses and parameters bit
    for bit, and the given trees are left alone."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    params = init_tree(braggnn.specs(1, IMG),
                       torch.Generator().manual_seed(0))
    params = map_tree(lambda t: t.to(cuda), params)
    gen = torch.Generator().manual_seed(1)
    batches = [tuple(t.to(cuda) for t in braggnn.synthetic_peaks(64, IMG,
                                                                 gen))
               for _ in range(5)]
    cfg = adamw.AdamWConfig(**RECIPE)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        step = braggnn.make_step(cfg)
        runs = {}
        for label, fn in (("graph", step), ("eager", step.eager)):
            given = (params, adamw.init_state(params))
            snap = [t.clone() for t in tree_leaves(given)]
            p, s = given
            losses = []
            for x, y in batches:
                p, s, loss = fn(p, s, x, y)
                losses.append(loss)
            runs[label] = ([float(v) for v in losses], tree_leaves((p, s)))
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(given), snap))
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
    assert runs["graph"][0] == runs["eager"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["graph"][1],
                                                 runs["eager"][1]))
