"""The LM's training in the port, held against the reference package:
``blockwise_attention`` and its VJP, K5's training path (its plain
version, with the rows' log-sum-exp, under the autograd Function),
``lm.train_loss`` and ``encdec.train_loss`` with their gradients,
``launch.steps.make_train_step`` (microbatches, grad compression), the
rematerialisation, the in-place AdamW, and the launcher.

Both packages get the same numpy inputs and weights, drawn from a seed by
the reference's ``init_tree`` rule over its spec tree; activations are
fp32, and the reference's calls are jitted once per case.  Tolerances:

* attention outputs and gradients at rtol 1e-5 / atol 1e-6: the same
  fp32 arithmetic in another framework (the port's blockwise backward
  takes K5's log-sum-exp where the reference keeps m and l);
* a model's loss at rtol 1e-5, and each gradient leaf within 1e-4 of its
  largest magnitude: the forward's fp32 sums taken in other orders,
  carried through the layers and the backward.  A leaf whose gradient is
  zero in exact arithmetic holds only rounding noise in either package
  (the sLSTM's input-gate bias: its stabiliser scales c and n alike, so
  h does not move with it); its scale is floored at 1e-3 of the model's
  largest gradient;
* a train step's loss and grad norm at rtol 1e-5 and 1e-4, its step count
  equal.  Its parameters are not compared: AdamW's normalised update
  turns a gradient near its eps (1e-8) into a step of any size up to the
  learning rate, so fp32 noise there moves a parameter by up to lr;
* the rematerialised forward and backward equal the plain one bit for
  bit: the same ops on the same values.

On the card (``gpu``): K5's log-sum-exp against its plain version, its
gradients against autograd through ``full_attention``; the sLSTM's
backward kernel against its plain reverse loop, and its Function against
autograd through the plain step loop; tiny Qwen2.5-3B's and tiny xLSTM's
train steps replayed against eager.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.nn import attention, module, transformer  # noqa: E402
from repro_torch.nn.module import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL, GRAD_SCALE_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (they import JAX, which the card's
    machine does not have: the ``gpu`` tests below do without them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.launch import steps as ref_steps
    from repro.models import encdec as ref_encdec
    from repro.models import lm as ref_lm
    from repro.nn import attention as ref_attn
    from repro.nn import module as ref_module
    from repro.nn import transformer as ref_tr
    from repro.optim import adamw as ref_adamw
    from repro.optim import compress as ref_compress
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=ref_registry, steps=ref_steps,
        encdec=ref_encdec, lm=ref_lm, attn=ref_attn, module=ref_module,
        tr=ref_tr, adamw=ref_adamw, compress=ref_compress)


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


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _leaf_close(got, want, floor=1e-30):
    """A gradient leaf within ``GRAD_SCALE_TOL`` of its largest magnitude
    (or of ``floor``, where that is larger)."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    bound = GRAD_SCALE_TOL * max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= bound


# ---------------------------------------------------------------------------
# blockwise attention and K5's training path
# ---------------------------------------------------------------------------

#: (S, query heads, kv heads, causal, window, soft-cap, block)
ATTN_CASES = {
    "causal": (64, 4, 4, True, None, 0.0, 32),
    "noncausal": (64, 4, 4, False, None, 0.0, 32),
    "window": (64, 4, 4, True, 8, 0.0, 32),
    "softcap": (64, 4, 4, True, None, 5.0, 32),
    "gqa": (64, 6, 2, True, 16, 0.0, 32),
    "ragged": (80, 4, 2, True, None, 0.0, 32),
}


def _qkv(case, seed=0):
    s, h, kv = ATTN_CASES[case][:3]
    rng = np.random.default_rng(seed)
    return (_rand(rng, 2, s, h, 16), _rand(rng, 2, s, kv, 16),
            _rand(rng, 2, s, kv, 16), _rand(rng, 2, s, h, 16))


def _ref_vjp(ref, case, q, k, v, do):
    s, _, _, causal, window, cap, block = ATTN_CASES[case]
    pos = ref.jnp.broadcast_to(ref.jnp.arange(s)[None], (2, s))

    def f(q, k, v):
        return ref.attn.blockwise_attention(
            q, k, v, q_pos=pos, k_pos=pos, causal=causal, window=window,
            logit_cap=cap, block_size=block)
    y, vjp = ref.jax.vjp(ref.jax.jit(f), q, k, v)
    return (y, *vjp(ref.jnp.asarray(do)))


def _grads(fn, q, k, v, do):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    y = fn(qt, kt, vt)
    y.backward(torch.from_numpy(do))
    return y, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention_and_vjp_match_reference(ref, case):
    s, _, _, causal, window, cap, block = ATTN_CASES[case]
    q, k, v, do = _qkv(case)
    want = _ref_vjp(ref, case, q, k, v, do)
    pos = torch.arange(s).expand(2, s)
    got = _grads(lambda a, b, c: attention.blockwise_attention(
        a, b, c, q_pos=pos, k_pos=pos, causal=causal, window=window,
        logit_cap=cap, block_size=block), q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", ["causal", "noncausal", "softcap", "gqa",
                                  "ragged"])
def test_flash_training_path_matches_reference_vjp(ref, case):
    """``positions=None``'s path: K5's plain version writes the rows'
    log-sum-exp, and the blockwise backward reads it: the reference's
    blockwise outputs and gradients."""
    _, _, _, causal, window, cap, _ = ATTN_CASES[case]
    q, k, v, do = _qkv(case, seed=1)
    want = _ref_vjp(ref, case, q, k, v, do)
    got = _grads(lambda a, b, c: fa_ops.attention(
        a, b, c, causal=causal, window=window, logit_cap=cap), q, k, v, do)
    for g, w in zip(got, want):
        _close(g, w)


def test_flash_plain_lse_is_the_rows_logsumexp():
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_rand(rng, 6, 33, 24)) for _ in range(3))
    out, lse = flash_attention_ref(q, k, v, causal=True, window=5,
                                   logit_cap=4.0, with_lse=True)
    s = torch.einsum("bqd,bkd->bqk", q, k) / np.sqrt(24)
    s = 4.0 * torch.tanh(s / 4.0)
    i = torch.arange(33)
    ok = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 5)
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), -1)
    _close(lse, want.numpy())
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True,
                                                window=5, logit_cap=4.0))


def test_self_attention_at_mrope_positions_has_the_reference_vjp(ref):
    """(B, 3, S) M-RoPE positions above the block: the blockwise path's
    gradients with respect to x and the projections."""
    cfg = registry.get_tiny("qwen2-vl-2b")
    s, d = 80, cfg.d_model
    specs = ref.attn.attn_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, qkv_bias=True)
    w = _init(ref, specs, 3)
    rng = np.random.default_rng(3)
    x, dy = _rand(rng, 2, s, d), _rand(rng, 2, s, d)
    pos = np.stack([np.arange(s), np.arange(s) // 4, np.arange(s) % 4])
    pos = np.broadcast_to(pos[None], (2, 3, s)).astype(np.int32)
    kw = dict(n_kv_heads=cfg.n_kv_heads, rope_theta=cfg.rope_theta,
              mrope_sections=cfg.mrope_sections, block_size=32)
    jw = ref.jax.tree_util.tree_map(ref.jnp.asarray, w)
    y, vjp = ref.jax.vjp(ref.jax.jit(lambda p, a: ref.attn.self_attention(
        p, a, ref.jnp.asarray(pos), **kw)), jw, ref.jnp.asarray(x))
    gw, gx = vjp(ref.jnp.asarray(dy))
    pw = module.map_tree(lambda a: a.requires_grad_(),
                         module.params_from_numpy(w))
    xt = torch.from_numpy(x).requires_grad_()
    got = attention.self_attention(pw, xt, torch.from_numpy(pos), **kw)
    got.backward(torch.from_numpy(dy))
    _close(got, y)
    _close(xt.grad, gx)
    for a, b in zip(tree_leaves(pw), ref.jax.tree_util.tree_leaves(gw)):
        _close(a.grad, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the losses and their gradients
# ---------------------------------------------------------------------------

#: architecture -> (batch, sequence) of the loss test: the dense and VLM
#: configs' sequences pass the tiny block of 64, where the reference
#: attends blockwise
LOSS_CASES = {"qwen2.5-3b": (2, 72), "qwen2-vl-2b": (2, 68),
              "qwen2-moe-a2.7b": (2, 16), "recurrentgemma-9b": (2, 16),
              "xlstm-1.3b": (2, 20), "whisper-tiny": (2, 12)}


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    targets = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    targets[:, -3:] = -1                         # not counted
    batch["targets"] = targets
    if cfg.n_patches:
        batch["patches"] = _rand(rng, b, cfg.n_patches, cfg.d_model)
    if cfg.is_encoder_decoder:
        batch["frames"] = _rand(rng, b, cfg.encoder_len, cfg.d_model)
    return batch


def _specs(cfg, pkg):
    return pkg.encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        pkg.tr.model_specs(cfg)


@pytest.mark.parametrize("arch", list(LOSS_CASES))
def test_train_loss_and_gradients_match_reference(ref, arch):
    rc = ref.registry.get_tiny(arch).replace(activation_dtype="float32")
    pc = registry.get_tiny(arch).replace(activation_dtype="float32")
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    w = _init(ref, _specs(rc, ref), 0)
    batch = _batch(rc, *LOSS_CASES[arch], seed=1)
    r_loss = ref.encdec.train_loss if rc.is_encoder_decoder else \
        ref.lm.train_loss
    (want, want_m), want_g = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: r_loss(rc, p, b), has_aux=True))(
        ref.jax.tree_util.tree_map(ref.jnp.asarray, w),
        {k: ref.jnp.asarray(v) for k, v in batch.items()})
    p_loss = encdec.train_loss if pc.is_encoder_decoder else lm.train_loss
    params = module.map_tree(lambda a: a.requires_grad_(),
                             module.params_from_numpy(w))
    got, got_m = p_loss(pc, params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    assert got_m.keys() == want_m.keys()
    for k in got_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if arch == "qwen2-moe-a2.7b":
        assert float(got_m["aux_loss"]) > 0.0
    want_g = ref.jax.tree_util.tree_leaves(want_g)
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max()) for g in want_g)
    for a, b in zip(tree_leaves(params), want_g):
        _leaf_close(a.grad, b, floor)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_equals_no_remat_bit_for_bit(policy):
    cfg = registry.get_tiny("qwen2-moe-a2.7b").replace(
        activation_dtype="float32", n_layers=2)
    w = module.init_tree(transformer.model_specs(cfg),
                         torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 12, 2).items()}
    out = {}
    for remat in ("none", policy):
        c = cfg.replace(remat=remat)
        p = module.map_tree(lambda a: a.clone().requires_grad_(), w)
        loss, m = lm.train_loss(c, p, batch)
        loss.backward()
        out[remat] = [loss.detach()] + [t.grad for t in tree_leaves(p)]
    for a, b in zip(out["none"], out[policy]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "microbatches", "compression"])
def test_train_step_matches_reference(ref, variant):
    """One step of ``make_train_step`` against the reference's: loss,
    grad norm and step count; every parameter moved, in place."""
    kw = {"microbatches": 2} if variant == "microbatches" else {}
    rc = ref.registry.get_tiny("qwen2.5-3b").replace(
        activation_dtype="float32", **kw)
    pc = registry.get_tiny("qwen2.5-3b").replace(activation_dtype="float32",
                                                 **kw)
    comp = variant == "compression"
    w = _init(ref, ref.tr.model_specs(rc), 4)
    batch = _batch(rc, 4, 24, seed=5)
    opt = dict(peak_lr=1e-2, warmup_steps=1)
    rp = ref.jax.tree_util.tree_map(ref.jnp.asarray, w)
    rs = ref.adamw.init_state(rp)
    if comp:
        rs["err"] = ref.compress.init_error_state(rp)
    rp, rs, rm = ref.jax.jit(ref.steps.make_train_step(
        rc, ref.adamw.AdamWConfig(**opt), grad_compression=comp))(
        rp, rs, {k: ref.jnp.asarray(v) for k, v in batch.items()})
    pp = module.params_from_numpy(w)
    ps = adamw.init_state(pp)
    if comp:
        ps["err"] = compress.init_error_state(pp)
    step = steps.make_train_step(pc, adamw.AdamWConfig(**opt),
                                 grad_compression=comp)
    leaves = tree_leaves(pp)
    new_p, ps, pm = step(pp, ps, batch)
    assert all(a is b for a, b in zip(tree_leaves(new_p), leaves))
    assert step.in_place
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-4)
    assert int(ps["step"]) == int(rs["step"]) == 1
    assert not any(np.array_equal(a.numpy(), w_) for a, w_ in zip(
        tree_leaves(new_p), tree_leaves(w)))


def test_train_step_refuses_shardings():
    """Shardings for parameters that are plain tensors are refused: the
    sharded step takes DTensors (``launch.shardings.shard_tree``)."""
    cfg = registry.get_tiny("qwen2.5-3b")
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    step = steps.make_train_step(cfg, grad_shardings={})
    with pytest.raises(ValueError, match="not DTensors"):
        step(params, adamw.init_state(params), _batch(cfg, 2, 8, 3))


def test_in_place_adamw_on_a_stacked_tree_matches_reference(ref):
    """``apply_updates`` writes a tiny LM's stacked leaves, moments and
    step in place, and equals the reference's functional update after
    three steps."""
    cfg = registry.get_tiny("qwen2.5-3b")
    w = _init(ref, ref.tr.model_specs(ref.registry.get_tiny("qwen2.5-3b")), 6)
    ocfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    rp = ref.jax.tree_util.tree_map(ref.jnp.asarray, w)
    rs = ref.adamw.init_state(rp)
    r_apply = ref.jax.jit(lambda p, g, s: ref.adamw.apply_updates(
        ref.adamw.AdamWConfig(**ocfg), p, g, s))
    pp = module.params_from_numpy(w)
    ps = adamw.init_state(pp)
    mu = tree_leaves(ps["mu"])
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = module.map_specs(lambda s: _rand(rng, *s.shape),
                             transformer.model_specs(cfg))
        rp, rs, rm = r_apply(rp, ref.jax.tree_util.tree_map(
            ref.jnp.asarray, g), rs)
        out = adamw.apply_updates(adamw.AdamWConfig(**ocfg), pp,
                                  module.params_from_numpy(g), ps)
        assert out[0] is pp and out[1] is ps
    assert all(a is b for a, b in zip(tree_leaves(ps["mu"]), mu))
    for t, r in ((pp, rp), (ps["mu"], rs["mu"]), (ps["nu"], rs["nu"])):
        for a, b in zip(tree_leaves(t), ref.jax.tree_util.tree_leaves(r)):
            _close(a, b, rtol=1e-5, atol=1e-7)
    assert int(ps["step"]) == 3


def test_launcher_trains_on_the_cpu_and_restarts(tmp_path):
    """``launch/train.py --tiny --device cpu``: four steps, a failure
    injected before the first periodic checkpoint restarts from the step-0
    checkpoint the in-place step asks for, and the losses equal an
    uninterrupted run's."""
    from repro_torch.launch import train
    args = ["--arch", "qwen2.5-3b", "--tiny", "--steps", "4", "--batch",
            "2", "--seq", "16", "--ckpt-every", "20", "--device", "cpu"]
    clean = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    failed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                "--fail-at", "2"])
    assert clean.restarts == 0 and failed.restarts == 1
    assert failed.losses[-4:] == clean.losses
    assert all(np.isfinite(clean.losses))


def test_launcher_refuses_the_encoder_decoder():
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="decoder-only"):
        train.main(["--arch", "whisper-tiny", "--tiny", "--device", "cpu"])


def test_prefill_and_serve_step_factories(ref):
    cfg = registry.get_tiny("qwen2-vl-2b").replace(activation_dtype="float32")
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 8, 8).items()}
    pre = steps.make_prefill(cfg)(params, b)
    assert torch.equal(pre, lm.prefill(cfg, params, b["tokens"],
                                       b["patches"]))
    cache = transformer.init_cache(cfg, 2, 4)
    nxt, _ = steps.make_serve_step(cfg)(
        params, cache, {"tokens": b["tokens"][:, :1],
                        "pos": torch.zeros(2, dtype=torch.int64)})
    assert nxt.shape == (2,) and nxt.dtype == torch.int32
    assert steps.metrics_structure() == ref.steps.metrics_structure()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["causal", "gqa", "softcap"])
def test_flash_lse_and_gradients_on_card(cuda, case):
    """K5's log-sum-exp against its plain version, and its training
    path's gradients against autograd through ``full_attention``, at rtol
    1e-4 / atol 1e-5 (fp32 sums in other orders)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    s, h, kv, causal, window, cap, _ = ATTN_CASES[case]
    q, k, v, do = (torch.from_numpy(a).to(cuda) for a in _qkv(case, 3))
    qh = q.transpose(1, 2).reshape(-1, s, 16).contiguous()
    kh = k.repeat_interleave(h // kv, 2).transpose(1, 2).reshape(
        -1, s, 16).contiguous()
    vh = v.repeat_interleave(h // kv, 2).transpose(1, 2).reshape(
        -1, s, 16).contiguous()
    kw = dict(causal=causal, window=window, logit_cap=cap)
    lse = torch.empty(qh.shape[:2], device=cuda)
    flash_attention(qh, kh, vh, lse=lse, **kw)
    _, want = flash_attention_ref(qh, kh, vh, with_lse=True, **kw)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-5)
    pos = torch.arange(s, device=cuda).expand(2, s)
    grads = []
    for fn in (lambda a, b, c: fa_ops.attention(a, b, c, **kw),
               lambda a, b, c: attention.full_attention(
                   a, b, c, q_pos=pos, k_pos=pos, **kw)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*ts).backward(do)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_replayed_train_step_equals_eager_on_card(cuda, monkeypatch):
    """Two steps of tiny Qwen2.5-3B at microbatches 2 replayed from the
    captured graph, against two eager steps on a copy, under deterministic
    algorithms: losses, parameters and moments value for value."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = registry.get_tiny("qwen2.5-3b").replace(microbatches=2)
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    trees = [module.map_tree(lambda t: t.to(cuda), params) for _ in range(2)]
    states = [adamw.init_state(t) for t in trees]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step = steps.make_train_step(cfg)
        for i in range(3):
            b = _batch(cfg, 4, 16, 10 + i)
            _, _, m_run = step(trees[0], states[0], b)
            _, _, m_eager = step.eager(trees[1], states[1], b)
            assert torch.equal(m_run["loss"], m_eager["loss"])
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*(tree_flatten((t, s))[0]
                      for t, s in zip(trees, states))):
        assert torch.equal(a, b)


def _slstm_inputs(cuda, b, s, nh, w, seed):
    """One sLSTM training call on the card: x_pre and R per gate (R at the
    spec's scale grown so the recurrence shows), the init state (zeros, m
    = -1e30) and a cotangent for hs."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x_pre = [torch.randn(b, s, nh, w, generator=g, device=cuda)
             for _ in range(4)]
    rec = [torch.randn(nh, w, w, generator=g, device=cuda) * w ** -0.5
           for _ in range(4)]
    state = [torch.zeros(b, nh, w, device=cuda) for _ in range(3)]
    state.append(torch.full((b, nh, w), -1e30, device=cuda))
    return x_pre, rec, state, torch.randn(b, s, nh, w, generator=g,
                                          device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,nh,w", [(1, 1024, 4, 512), (2, 37, 3, 36),
                                      (1, 5, 2, 20)])
def test_slstm_backward_kernel_matches_plain_on_card(cuda, b, s, nh, w):
    """The forward kernel's saves against the plain loop's, and the
    backward kernel against the plain reverse loop on the kernel's saves,
    at rtol 1e-4 / atol 1e-5 (fp32 sums in other orders, carried through
    the steps): xlstm-1.3b's training call, and W 36 and 20, which leave
    the cluster's last block part-filled and three blocks empty."""
    from repro_torch.kernels.slstm_scan.ref import (slstm_scan_backward_ref,
                                                    slstm_scan_ref)
    from repro_torch.kernels.slstm_scan.slstm_scan import (
        SAVES, slstm_scan, slstm_scan_backward)
    x_pre, rec, state, dhs = _slstm_inputs(cuda, b, s, nh, w, w)
    saves = [torch.empty_like(dhs) for _ in SAVES]
    plain = [torch.empty_like(dhs) for _ in SAVES]
    slstm_scan(x_pre, rec, *[t.clone() for t in state], saves=saves)
    slstm_scan_ref(x_pre, rec, *[t.clone() for t in state], saves=plain)
    for a, b_ in zip(saves, plain):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5)
    n = slstm_scan_backward.launches
    got = slstm_scan_backward(dhs, rec, saves, *state[1:])
    assert slstm_scan_backward.launches == n + 1
    want = slstm_scan_backward_ref(dhs, rec, saves, *state[1:])
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_slstm_function_gradients_on_card(cuda):
    """The sLSTM Function on the card (both kernels, R's gradient as one
    product per gate) against autograd through the plain step loop on the
    card, one forward and one backward launch."""
    from repro_torch.kernels import registry as kernels
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    x_pre, rec, state, dhs = _slstm_inputs(cuda, 2, 29, 3, 36, 7)
    grads = []
    for fn in (slstm_ops.scan, slstm_scan_ref):
        ts = [t.clone().requires_grad_() for t in x_pre + rec]
        kernels.reset_launch_counts()
        hs = fn(ts[:4], ts[4:], *[t.clone() for t in state])
        grads.append(torch.autograd.grad(hs, ts, dhs))
        if fn is slstm_ops.scan:
            launched = {k: v for k, v in kernels.launch_counts().items()
                        if v}
            assert launched == {"slstm_scan": 1, "slstm_scan_backward": 1}
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_replayed_xlstm_train_step_equals_eager_on_card(cuda, monkeypatch):
    """Two steps of tiny xLSTM at microbatches 2 replayed from the
    captured graph, the sLSTM's kernels inside it, against two eager steps
    on a copy under deterministic algorithms: losses, parameters and
    moments value for value; 4 forward launches (2 microbatches, forward
    and remat recompute) and 2 backward launches a replay."""
    from repro_torch.kernels import registry as kernels
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = registry.get_tiny("xlstm-1.3b").replace(microbatches=2)
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    trees = [module.map_tree(lambda t: t.to(cuda), params) for _ in range(2)]
    states = [adamw.init_state(t) for t in trees]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step = steps.make_train_step(cfg)
        for i in range(3):
            b = _batch(cfg, 4, 16, 10 + i)
            kernels.reset_launch_counts()
            _, _, m_run = step(trees[0], states[0], b)
            if i:
                assert {k: v for k, v in kernels.launch_counts().items()
                        if v} == {"slstm_scan": 4, "slstm_scan_backward": 2}
            _, _, m_eager = step.eager(trees[1], states[1], b)
            assert torch.isfinite(m_run["loss"])
            assert torch.equal(m_run["loss"], m_eager["loss"])
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*(tree_flatten((t, s))[0]
                      for t, s in zip(trees, states))):
        assert torch.equal(a, b)
