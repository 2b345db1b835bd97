"""xLSTM in the port, held against the reference package: the mLSTM and
sLSTM blocks (``nn/xlstm.py``), the sLSTM time loop's plain version
(``kernels/slstm_scan``), the models built of them (``xlstm-1.3b``'s
``tiny()`` and ``tests/test_nn_blocks.py``'s ``xlstm`` config), their
caches, the engine and the launcher.

Both packages get the same numpy inputs and weights, drawn from a seed
(the weights by the reference's ``init_tree`` rule over its spec tree).
Tolerances:

* the conv, one mLSTM chunk, the chunkwise cell, the sLSTM loop and the
  blocks at fp32: within 1e-5 of the output's scale (max |y|): the same
  fp32 arithmetic in another framework, products summed in other orders
  (the reference's ``cumsum`` and ``einsum`` lower through XLA);
* the model at fp32: logits within 1e-4 of their scale and greedy tokens
  equal, the LM's bar (``PERF.md`` §2); the engine's token lists equal
  the reference engine's;
* the cache's dtypes after a step equal the reference's (ROADMAP.md R8);
* on the card: the kernel against its plain version at rtol 1e-4 / atol
  1e-5 (fp32 sums in another order, carried through the recurrence); the
  model within 1e-3 of the scale of its CPU run at fp32; a replayed
  decode step equal to the eager one value for value.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.graphs import GraphRunner  # noqa: E402
from repro_torch.kernels.slstm_scan import ops as slstm_ops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import module, transformer, xlstm  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

BLOCK_SCALE_TOL = 1e-5
FP32_SCALE_TOL = 1e-4
CARD_SCALE_TOL = 1e-3
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
ARCH = "xlstm-1.3b"

#: tests/test_nn_blocks.py's xlstm config, as keyword arguments
XLSTM = dict(name="t", family="ssm", n_layers=4, d_model=32, n_heads=4,
             n_kv_heads=4, d_ff=0, vocab_size=64, mlstm_chunk=8,
             attn_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
             attn_block_size=32)
D, H, CHUNK = 32, 4, 8               # the blocks' width, heads and chunk
F32 = torch.float32


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
    from repro.nn import transformer as ref_tr
    from repro.nn import xlstm as ref_xlstm
    from repro.serving.engine import ServingEngine as RefEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=ref_registry,
                                 Config=RefConfig, lm=ref_lm,
                                 module=ref_module, xlstm=ref_xlstm,
                                 tr=ref_tr, Engine=RefEngine)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _scale_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _model(ref, name, dtype="float32"):
    """(reference config, port config, reference params, port params)."""
    if name == "xlstm":
        rc, pc = ref.Config(**XLSTM), ModelConfig(**XLSTM)
    else:
        rc, pc = ref.registry.get_tiny(ARCH), registry.get_tiny(ARCH)
    rc, pc = (c.replace(activation_dtype=dtype) for c in (rc, pc))
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = _init(ref, ref.tr.model_specs(rc), 0)
    return rc, pc, ref.jax.tree_util.tree_map(ref.jnp.asarray, rp), \
        module.params_from_numpy(rp)


def _init(ref, specs, seed):
    """Weights for the reference's spec tree, drawn with numpy by its
    ``init_tree``'s rule (normal at ``scale`` or 1/sqrt(fan_in), zeros,
    ones): one draw for both packages, without a JAX compile per leaf."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = spec.scale if spec.scale is not None else spec.fan_in() ** -0.5
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)
    return ref.module.map_specs(draw, specs)


def _both(ref, specs, seed, rec_scale=None):
    """A block's weights (the reference's init; sLSTM recurrent weights
    drawn at ``rec_scale`` so the recurrence shows) in both packages."""
    p = _np(_init(ref, specs, seed))
    rng = np.random.default_rng(seed)
    for sub in ("conv", "igate", "fgate"):
        if sub in p:
            p[sub]["bias"] = rng.normal(0, 0.5, p[sub]["bias"].shape
                                        ).astype(np.float32)
    for g in p.get("gates", {}).values():
        g["bias"] = rng.normal(0, 0.5, g["bias"].shape).astype(np.float32)
        if rec_scale:
            g["rec"] = rng.normal(0, rec_scale, g["rec"].shape).astype(
                np.float32)
    return (ref.jax.tree_util.tree_map(ref.jnp.asarray, p),
            module.params_from_numpy(p))


# ---------------------------------------------------------------------------
# the conv, the mLSTM cell and the sLSTM loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_conv4_matches_reference(ref, with_state):
    p = {"kernel": _rand(0, 4, 12), "bias": _rand(1, 12)}
    x, st = _rand(2, 2, 9, 12), _rand(3, 2, 3, 12)
    want, want_st = ref.xlstm._conv4(
        {k: ref.jnp.asarray(v) for k, v in p.items()}, ref.jnp.asarray(x),
        ref.jnp.asarray(st) if with_state else None)
    got, got_st = xlstm._conv4(module.params_from_numpy(p), _t(x),
                               _t(st) if with_state else None)
    assert _scale_err(got, want) <= BLOCK_SCALE_TOL
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


def _cell_inputs(seed, s, *, b=2, h=3, d=5):
    q, k, v = (_rand(seed + i, b, s, h, d) for i in range(3))
    log_f = np.log(1 / (1 + np.exp(-_rand(seed + 3, b, s, h) - 1.0))
                   ).astype(np.float32)
    log_i = _rand(seed + 4, b, s, h)
    return q, k, v, log_f, log_i


def test_mlstm_chunk_matches_reference_from_a_state(ref):
    ins = _cell_inputs(10, 6)
    state = (_rand(20, 2, 3, 5, 5), _rand(21, 2, 3, 5), _rand(22, 2, 3))
    want_h, want_st = ref.jax.jit(ref.xlstm._mlstm_chunk)(
        *map(ref.jnp.asarray, ins), tuple(map(ref.jnp.asarray, state)))
    got_h, got_st = xlstm._mlstm_chunk(*map(_t, ins), tuple(map(_t, state)))
    assert _scale_err(got_h, want_h) <= BLOCK_SCALE_TOL
    for g, w in zip(got_st, want_st):
        assert _scale_err(g, w) <= BLOCK_SCALE_TOL


@pytest.mark.parametrize("s", [5, 24, 21])      # <= chunk, a multiple, ragged
def test_mlstm_cell_matches_reference(ref, s):
    ins = _cell_inputs(s, s)
    want_h, want_st = ref.jax.jit(ref.xlstm.mlstm_cell, static_argnames=(
        "chunk",))(*map(ref.jnp.asarray, ins), chunk=CHUNK)
    got_h, got_st = xlstm.mlstm_cell(*map(_t, ins), chunk=CHUNK)
    assert got_h.shape == (2, s, 3, 5)
    assert _scale_err(got_h, want_h) <= BLOCK_SCALE_TOL
    for g, w in zip(got_st, want_st):
        assert _scale_err(g, w) <= BLOCK_SCALE_TOL


def test_slstm_plain_loop_matches_reference_scan(ref):
    """The kernel's plain version against the reference's ``_slstm_scan``
    from a drawn state, the state written back in place."""
    b, s, w = 2, 11, 6
    x_pre = {g: _rand(30 + i, b, s, H, w) for i, g in enumerate("ifzo")}
    rec = {g: _rand(40 + i, H, w, w, scale=0.4) for i, g in enumerate("ifzo")}
    h0, c0, n0 = (_rand(50 + i, b, H, w) for i in range(3))
    n0 = np.abs(n0)
    m0 = _rand(53, b, H, w)
    p = {"gates": {g: {"rec": ref.jnp.asarray(rec[g])} for g in rec}}
    want_hs, want_st = ref.xlstm._slstm_scan(
        p, {g: ref.jnp.asarray(x) for g, x in x_pre.items()},
        *map(ref.jnp.asarray, (h0, c0, n0, m0)))
    state = [_t(a.copy()) for a in (h0, c0, n0, m0)]
    got = slstm_scan_ref([_t(x_pre[g]) for g in "ifzo"],
                         [_t(rec[g]) for g in "ifzo"], *state)
    assert _scale_err(got, want_hs) <= BLOCK_SCALE_TOL
    for g, w_ in zip(state, want_st):
        assert _scale_err(g, w_) <= BLOCK_SCALE_TOL
    # the CPU wrapper is the plain version
    again = [_t(a.copy()) for a in (h0, c0, n0, m0)]
    assert torch.equal(slstm_ops.scan([_t(x_pre[g]) for g in "ifzo"],
                                      [_t(rec[g]) for g in "ifzo"], *again),
                       got)


def _slstm_case(b, s, w, nh=3, start="init"):
    """Numpy inputs of one sLSTM call: x_pre and R per gate, the state it
    starts from (``init``: zeros and m = -1e30, as training starts;
    ``cached``: a drawn state, as a decode continues) and a cotangent."""
    x_pre = {g: _rand(60 + i, b, s, nh, w) for i, g in enumerate("ifzo")}
    rec = {g: _rand(70 + i, nh, w, w, scale=0.4) for i, g in enumerate("ifzo")}
    if start == "init":
        st = [np.zeros((b, nh, w), np.float32) for _ in range(3)]
        st.append(np.full((b, nh, w), xlstm.M_INIT, np.float32))
    else:
        st = [_rand(80 + i, b, nh, w) for i in range(4)]
        st[2] = np.abs(st[2])
    return x_pre, rec, st, _rand(90, b, s, nh, w)


def _function_grads(x_pre, rec, st, dhs, fn=slstm_ops.scan):
    """hs, the state written back, and the gradients of x_pre and rec (in
    the order i, f, z, o) of ``fn`` on fresh tensors."""
    xs = [_t(x_pre[g]).requires_grad_() for g in "ifzo"]
    rs = [_t(rec[g]).requires_grad_() for g in "ifzo"]
    state = [_t(a.copy()) for a in st]
    hs = fn(xs, rs, *state)
    grads = torch.autograd.grad(hs, xs + rs, _t(dhs))
    return hs.detach(), state, grads


@pytest.mark.parametrize("start", ["init", "cached"])
@pytest.mark.parametrize("b,s,w", [(2, 12, 8), (1, 20, 4)])
def test_slstm_gradients_match_reference_vjp(ref, b, s, w, start):
    """The sLSTM Function (the plain forward and the plain reverse loop on
    the CPU) against ``jax.vjp`` of the reference's ``_slstm_scan`` on hs:
    the gradients of x_pre and R at rtol 1e-4 / atol 1e-5, and the
    forward's hs and written-back state at the blocks' bar; from the
    training's init state and from a cached one."""
    x_pre, rec, st, dhs = _slstm_case(b, s, w, start=start)
    jx = {g: ref.jnp.asarray(a) for g, a in x_pre.items()}
    jp = {"gates": {g: {"rec": ref.jnp.asarray(a)} for g, a in rec.items()}}
    (want_hs, want_st), vjp = ref.jax.vjp(
        lambda p, x: ref.xlstm._slstm_scan(p, x, *map(ref.jnp.asarray, st)),
        jp, jx)
    zero_st = ref.jax.tree_util.tree_map(ref.jnp.zeros_like, want_st)
    want_dp, want_dx = vjp((ref.jnp.asarray(dhs), zero_st))
    hs, state, grads = _function_grads(x_pre, rec, st, dhs)
    assert _scale_err(hs, want_hs) <= BLOCK_SCALE_TOL
    for g_, w_ in zip(state, want_st):
        assert _scale_err(g_, w_) <= BLOCK_SCALE_TOL
    want = [want_dx[g] for g in "ifzo"] + [want_dp["gates"][g]["rec"]
                                           for g in "ifzo"]
    for got, w_ in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_),
                                   rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("start", ["init", "cached"])
def test_slstm_gradients_match_autograd_through_plain_loop(start):
    """The Function's gradients against autograd through the plain step
    loop, which runs the same forward ops: the explicit reverse loop is
    autograd's derivative (the random data hold no ties)."""
    x_pre, rec, st, dhs = _slstm_case(2, 16, 8, start=start)
    hs, state, grads = _function_grads(x_pre, rec, st, dhs)
    hs_a, state_a, grads_a = _function_grads(x_pre, rec, st, dhs,
                                             fn=slstm_scan_ref)
    assert torch.equal(hs, hs_a)
    assert all(torch.equal(a, b) for a, b in zip(state, state_a))
    for a, b in zip(grads, grads_a):
        torch.testing.assert_close(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.parametrize("start", ["init", "cached"])
def test_slstm_plain_backward_passes_gradcheck(start):
    """The plain backward at (1, 4, 2, 4) in float64 against finite
    differences of the plain forward (``torch.autograd.gradcheck``)."""
    x_pre, rec, st, _ = _slstm_case(1, 4, 4, nh=2, start=start)
    xr = [_t(a[g]).double().requires_grad_() for a in (x_pre, rec)
          for g in "ifzo"]

    def f(*xr):
        state = [_t(a.copy()).double() for a in st]
        return slstm_ops.scan(xr[:4], xr[4:], *state)

    assert torch.autograd.gradcheck(f, tuple(xr))


def test_slstm_state_that_needs_a_gradient_is_refused():
    x_pre, rec, st, _ = _slstm_case(1, 3, 4)
    state = [_t(a.copy()) for a in st]
    state[1].requires_grad_()
    with pytest.raises(ValueError, match="takes no gradient"):
        slstm_ops.scan([_t(x_pre[g]) for g in "ifzo"],
                       [_t(rec[g]) for g in "ifzo"], *state)


# ---------------------------------------------------------------------------
# the blocks, prefill and decode
# ---------------------------------------------------------------------------

def _block_case(ref, kind):
    if kind == "mlstm":
        specs = ref.xlstm.mlstm_block_specs(D, H)
        rp, pp = _both(ref, specs, 5)
        cache = ref.xlstm.init_mlstm_cache(2, D, H)
        fns = (ref.jax.jit(lambda p, x, c=None: ref.xlstm.mlstm_block(
            p, x, n_heads=H, chunk=CHUNK, cache=c)),
            lambda p, x, c=None: xlstm.mlstm_block(
                p, x, n_heads=H, chunk=CHUNK, cache=c))
        port_cache = xlstm.init_mlstm_cache(2, D, H, conv_dtype=F32)
    else:
        specs = ref.xlstm.slstm_block_specs(D, H)
        rp, pp = _both(ref, specs, 6, rec_scale=0.3)
        cache = ref.xlstm.init_slstm_cache(2, D, H)
        fns = (ref.jax.jit(lambda p, x, c=None: ref.xlstm.slstm_block(
            p, x, n_heads=H, cache=c)),
            lambda p, x, c=None: xlstm.slstm_block(p, x, n_heads=H, cache=c))
        port_cache = xlstm.init_slstm_cache(2, D, H, conv_dtype=F32)
    return rp, pp, cache, port_cache, fns


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_matches_reference(ref, kind):
    rp, pp, _, _, (ref_fn, port_fn) = _block_case(ref, kind)
    x = _rand(7, 2, 19, D)
    want, none = ref_fn(rp, ref.jnp.asarray(x))
    got, cache = port_fn(pp, _t(x))
    assert none is None and cache is None
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _scale_err(got, want) <= BLOCK_SCALE_TOL


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_reference(ref, kind):
    """Six decode steps through the block's cache: every step's output and
    every cache leaf after it, the port's cache written in place.  The
    reference's block hands back its conv state in the activation dtype
    (fp32) from the first step on, so the port's cache holds it in fp32."""
    rp, pp, cache, port_cache, (ref_fn, port_fn) = _block_case(ref, kind)
    xs = _rand(8, 2, 6, D)
    for t in range(6):
        want, cache = ref_fn(rp, ref.jnp.asarray(xs[:, t:t + 1]), cache)
        got, same = port_fn(pp, _t(xs[:, t:t + 1]), port_cache)
        assert same is port_cache
        assert _scale_err(got, want) <= BLOCK_SCALE_TOL
    for name in cache:
        assert _scale_err(port_cache[name], cache[name]) <= BLOCK_SCALE_TOL


# ---------------------------------------------------------------------------
# the model, its cache and its spec tree
# ---------------------------------------------------------------------------

def test_model_matches_reference_at_fp32(ref):
    """tests/test_nn_blocks.py's xlstm config: forward's logits (S over
    three chunks, the last ragged), greedy tokens equal.  (xlstm-1.3b's
    tiny() runs through test_torch_lm.py's model tests: forward, prefill,
    decode steps and serve_step at fp32 and bf16.)"""
    rc, pc, rp, pp = _model(ref, "xlstm")
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 21))
    want = np.asarray(ref.jax.jit(lambda t: ref.tr.forward(rc, rp, t)[0])(
        ref.jnp.asarray(toks)))
    got = transformer.forward(pc, pp, _t(toks))[0]
    assert _scale_err(got, want) <= FP32_SCALE_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_dtypes_after_a_step_equal_reference(ref, dtype):
    """Six layers over a period of four: one stacked superblock and two
    remainder mLSTM layers.  The port allocates the dtypes the
    reference's cache holds after one step (R8): stacked conv states in
    bf16, remainder ones in the activation dtype, the cells' state fp32."""
    rc, pc, rp, _ = _model(ref, "xlstm", dtype)
    rc, pc = (c.replace(n_layers=6) for c in (rc, pc))
    rp = ref.jax.tree_util.tree_map(ref.jnp.asarray,
                                    _init(ref, ref.tr.model_specs(rc), 0))
    _, stepped = ref.jax.eval_shape(
        lambda c: ref.tr.decode_step(rc, rp, ref.jnp.ones((2, 1), "int32"),
                                     c, ref.jnp.zeros(2, "int32")),
        ref.tr.init_cache(rc, 2, 8))
    port = transformer.init_cache(pc, 2, 8)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat(stepped).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _flat(port).items()}
    assert got == want
    assert got["extra/0/conv"][1] == dtype
    assert got["blocks/3/conv"][1] == "bfloat16"


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def test_spec_tree_count_and_flops_equal_reference(ref):
    for get, ref_get in ((registry.get_config, ref.registry.get_config),
                         (registry.get_tiny, ref.registry.get_tiny)):
        port = transformer.model_specs(get(ARCH))
        want = ref.tr.model_specs(ref_get(ARCH))
        assert {k: (tuple(v.shape), tuple(v.axes), v.init, v.scale)
                for k, v in _flat(port).items()} == \
            {k: (tuple(v.shape), tuple(v.axes), v.init, v.scale)
             for k, v in _flat(want).items()}
        assert module.param_count(port) == ref.module.param_count(want)
        assert lm.model_flops_per_token(get(ARCH)) == \
            ref.lm.model_flops_per_token(ref_get(ARCH))
    full = registry.get_config(ARCH)
    specs = transformer.model_specs(full)
    per = {k: module.param_count(specs["blocks"][str(i)]) // 6
           for i, k in ((0, "mlstm"), (7, "slstm"))}
    # 42 mLSTM layers and 6 sLSTM layers, at d_model 2,048 and 4 heads
    assert (full.n_layers, full.n_superblocks, full.d_model) == (48, 6, 2048)
    assert per == {"mlstm": 75_556_872, "slstm": 37_767_168}
    assert module.param_count(specs) == 3_503_016_272


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


def _tiny_engine(max_batch=1, max_len=48):
    cfg = registry.get_tiny(ARCH).replace(activation_dtype="float32")
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(2))
    return ServingEngine(cfg, params, max_batch=max_batch, max_len=max_len)


def test_lane_reuse_resets_recurrent_state():
    """tests/test_serving.py's check for xLSTM: the same prompt through the
    same lane after other traffic gives the same tokens."""
    eng = _tiny_engine()
    eng.submit([3, 4, 5], max_new_tokens=5)
    first = eng.run_until_drained()[-1].output
    eng.submit([20, 21, 22, 23, 24, 25], max_new_tokens=5)
    eng.run_until_drained()
    eng.submit([3, 4, 5], max_new_tokens=5)
    assert eng.run_until_drained()[-1].output == first


def test_lane_reset_restores_init_values():
    """After a request the lane's state is non-zero; the reset writes the
    init values back into that lane alone: m = -1e30 in both cells, every
    other leaf zero."""
    eng = _tiny_engine(max_batch=2)
    eng.submit(list(range(1, 12)), max_new_tokens=4)
    eng.submit([7, 8], max_new_tokens=9)
    while len(eng.finished) < 1:
        eng.tick()
    blocks = eng.cache["blocks"]
    assert float(blocks["0"]["C"][:, 0].abs().max()) > 0
    assert float(blocks["3"]["h"][:, 0].abs().max()) > 0
    busy = module.map_tree(lambda a: a[:, 1].clone(), blocks)
    eng._reset_lane_cache(0)
    for name, leaf in _flat(blocks).items():
        lane = leaf[:, 0]
        if name.endswith("/m"):
            assert bool((lane == xlstm.M_INIT).all()), name
        else:
            assert not bool(lane.any()), name
    for a, b in zip(module.tree_leaves(busy),
                    module.tree_leaves(module.map_tree(lambda a: a[:, 1],
                                                       blocks))):
        assert torch.equal(a, b)


def test_serve_cli_on_cpu(capsys):
    stats = serve.main(["--arch", ARCH, "--requests", "3", "--max-batch",
                        "2", "--new-tokens", "5", "--device", "cpu"])
    assert stats["requests"] == 3 and stats["generated_tokens"] == 15
    assert "[serve] xlstm-tiny" in capsys.readouterr().out


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
@pytest.mark.parametrize("b,s,nh,w", [(2, 37, 4, 16), (3, 5, 2, 20),
                                      (2, 64, 4, 512), (8, 1, 4, 512)])
def test_slstm_kernel_matches_plain_on_card(cuda, b, s, nh, w):
    """The kernel against its plain version on the same card: hs and the
    state written back, one launch; W 20 leaves three blocks of the
    cluster without units."""
    from repro_torch.kernels.slstm_scan.slstm_scan import slstm_scan
    g = torch.Generator(device=cuda).manual_seed(w)
    x_pre = [torch.randn(b, s, nh, w, generator=g, device=cuda)
             for _ in range(4)]
    rec = [torch.randn(nh, w, w, generator=g, device=cuda) * w ** -0.5
           for _ in range(4)]
    st = [torch.randn(b, nh, w, generator=g, device=cuda) for _ in range(4)]
    st[2] = st[2].abs()
    mine = [t.clone() for t in st]
    n = slstm_scan.launches
    got = slstm_scan(x_pre, rec, *mine)
    assert slstm_scan.launches == n + 1
    want = slstm_scan_ref(x_pre, rec, *st)
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    for a, b_ in zip(mine, st):
        torch.testing.assert_close(a, b_, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


@pytest.mark.gpu
def test_slstm_kernel_refuses_what_float4_cannot_read(cuda):
    """R is read as float4: a width off a multiple of 4, or an R that does
    not start on a 16-byte boundary, is refused before any launch."""
    from repro_torch.kernels.slstm_scan.slstm_scan import slstm_scan

    def args(w, shift=0):
        x_pre = [torch.zeros(1, 2, 1, w, device=cuda) for _ in range(4)]
        rec = [torch.zeros(w * w + shift, device=cuda)[shift:].view(1, w, w)
               for _ in range(4)]
        return x_pre, rec, *[torch.zeros(1, 1, w, device=cuda)
                             for _ in range(4)]

    n = slstm_scan.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        slstm_scan(*args(6))
    with pytest.raises(ValueError, match="16-byte"):
        slstm_scan(*args(8, shift=1))
    assert slstm_scan.launches == n


@pytest.mark.gpu
def test_model_on_card_matches_its_cpu_run(cuda):
    """The tiny model's forward (the sLSTM kernel) and ten decode steps
    at fp32 on the card, against the same on the CPU."""
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
    """The bf16 decode step captured into a CUDA graph, the sLSTM kernel
    inside it: each replay writes the cells' state in place, equal value
    for value to the eager step on a copy of the same cache."""
    from repro_torch.kernels import registry as kernels
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
        kernels.reset_launch_counts()
        got = run({"tokens": toks, "pos": pos})
        assert kernels.launch_counts()["slstm_scan"] == 1
        assert torch.equal(got, want)
        for a, b in zip(module.tree_leaves(cache), module.tree_leaves(twin)):
            assert torch.equal(a, b)
    assert len(run.replay_launches()) == 1
