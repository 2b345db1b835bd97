"""The MoE family in the port, held against the reference package: the
layer (``nn/moe.py``), the two MoE configs' models and the engine.

Both packages get the same numpy inputs (from a seed) and the reference's
``init_tree(specs, PRNGKey)`` weights as numpy.  Tolerances:

* the layer at fp32: ``y`` rtol 1e-5 / atol 1e-6, ``aux`` 1e-6 (the same
  fp32 arithmetic in another framework; the routing, the drops and the
  order of the combine are the reference's);
* the layer at bf16: within max(2%, 2 x the reference's own bf16 error) of
  the scale from the reference's fp32 output, the LM's bf16 bar;
* the tiny models at fp32: greedy tokens equal, and the engine's token
  lists equal the reference engine's;
* on the card: the layer within rtol 1e-4 / atol 1e-5 of its CPU run at
  fp32 (cuBLAS sums in another order), and a replayed step equal to the
  eager one value for value at bf16 (the combine's fixed order).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.graphs import GraphRunner  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import module, moe, transformer  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

RTOL, ATOL, AUX_TOL = 1e-5, 1e-6, 1e-6
BF16_SCALE_TOL = 0.02
MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")

#: layer cases: (E padded, real experts, top_k, shared d_ff, token_chunks,
#: capacity_factor)
CASES = {
    "padding 3 of 8": (8, 3, 2, 0, 1, 1.25),
    "shared experts": (4, 4, 2, 32, 1, 1.25),
    "chunks 1": (6, 6, 2, 0, 1, 1.25),
    "chunks 4": (6, 6, 2, 0, 4, 1.25),
    "tokens dropped": (4, 4, 2, 0, 1, 0.5),
    "all at once": (8, 6, 2, 32, 4, 1.25),
}
D, FF, B, S = 16, 24, 2, 16


@pytest.fixture(scope="module")
def ref():
    """The reference package's modules (they import JAX, which the card's
    machine does not have: the ``gpu`` tests below do without them)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry as ref_registry
    from repro.models import lm as ref_lm
    from repro.nn import module as ref_module
    from repro.nn import moe as ref_moe
    from repro.nn import transformer as ref_tr
    from repro.serving.engine import ServingEngine as RefEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=ref_registry,
                                 lm=ref_lm, module=ref_module, moe=ref_moe,
                                 tr=ref_tr, Engine=RefEngine)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _case(name):
    e, real, k, ff_sh, chunks, cf = CASES[name]
    specs = moe.moe_specs(D, real, FF, n_experts_padded=e,
                          n_shared=1 if ff_sh else 0, shared_d_ff=ff_sh)
    kw = dict(n_experts=real, top_k=k, capacity_factor=cf,
              token_chunks=chunks)
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(
        np.float32)
    return specs, kw, x


def _ref_layer(ref, name):
    """(numpy weights, the reference's fp32 y and aux, its bf16 y, input,
    keywords) of one case."""
    specs, kw, x = _case(name)
    rp = ref.module.init_tree(ref.moe.moe_specs(
        D, kw["n_experts"], FF, n_experts_padded=CASES[name][0],
        n_shared=1 if CASES[name][3] else 0, shared_d_ff=CASES[name][3]),
        ref.jax.random.key(0))
    y, aux = ref.moe.moe(rp, ref.jnp.asarray(x), **kw)
    y16, _ = ref.moe.moe(rp, ref.jnp.asarray(x, ref.jnp.bfloat16), **kw)
    return _np(rp), np.asarray(y), float(aux), np.asarray(
        y16.astype(ref.jnp.float32)), x, kw


def _spec_fields(tree):
    """Shape, axes and init scale of every leaf of a spec tree (either
    package's ``ParamSpec``)."""
    if isinstance(tree, dict):
        return {k: _spec_fields(v) for k, v in tree.items()}
    return tuple(tree.shape), tuple(tree.axes), tree.scale


def _scale_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_moe_matches_reference_at_fp32(ref, name):
    w, want, want_aux, _, x, kw = _ref_layer(ref, name)
    y, aux = moe.moe(module.params_from_numpy(w), torch.from_numpy(x), **kw)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
    assert abs(float(aux) - want_aux) <= AUX_TOL
    if name == "tokens dropped":
        r = moe.route(torch.from_numpy(x).reshape(-1, D),
                      torch.tensor(w["router"]["kernel"]),
                      n_experts=kw["n_experts"], top_k=kw["top_k"],
                      capacity_factor=kw["capacity_factor"])
        assert 0 < float(r.keep.sum()) < r.keep.numel()


@pytest.mark.parametrize("name", list(CASES))
def test_moe_bf16_within_the_reference_bar(ref, name):
    w, want, _, ref16, x, kw = _ref_layer(ref, name)
    y, _ = moe.moe(module.params_from_numpy(w),
                   torch.from_numpy(x).bfloat16(), **kw)
    assert y.dtype == torch.bfloat16
    assert _scale_err(y.float().numpy(), want) <= max(
        BF16_SCALE_TOL, 2 * _scale_err(ref16, want))


def test_padding_experts_are_never_chosen():
    """Masked padding experts get probability exactly 0, so top-k never
    picks one while top_k is at most the real experts; asking for more
    raises."""
    specs, kw, x = _case("padding 3 of 8")
    p = module.init_tree(specs, torch.Generator().manual_seed(0))
    r = moe.route(torch.from_numpy(x).reshape(-1, D), p["router"]["kernel"],
                  n_experts=3, top_k=3, capacity_factor=1.25)
    assert bool((r.probs[:, 3:] == 0).all()) and bool(
        (r.probs[:, :3] > 0).all())
    assert r.counts[3:].sum() == 0 and int(r.counts.sum()) == B * S * 3
    with pytest.raises(ValueError, match="top_k"):
        moe.moe(p, torch.from_numpy(x), n_experts=3, top_k=4)


def test_combine_adds_in_ascending_expert_order():
    """The contributions of a token come back in its sorted assignments'
    order, which ascends with the expert id; the routing plan keeps each
    expert's first ``capacity`` assignments in token order."""
    specs, kw, x = _case("tokens dropped")
    p = module.init_tree(specs, torch.Generator().manual_seed(4))
    xt = torch.from_numpy(x).reshape(-1, D)
    r = moe.route(xt, p["router"]["kernel"], n_experts=4, top_k=2,
                  capacity_factor=0.5)
    experts = r.slot // r.capacity
    assert bool((experts[1:] >= experts[:-1]).all())
    for e in range(4):
        tokens = r.token[experts == e]
        assert bool((tokens[1:] > tokens[:-1]).all())
        kept = r.keep[experts == e]
        assert float(kept.sum()) == min(r.capacity, len(tokens))
        assert bool((kept[:r.capacity] == 1).all())


# ---------------------------------------------------------------------------
# token chunks: one pass over every chunk
# ---------------------------------------------------------------------------

#: 64 tokens of width D routed over 4 experts, top 2, capacity factor 1
N_TOK, E4, CHUNK_CF = 64, 4, 1.0


def _chunk_case():
    """Router weights whose logits are 10·x[:4], and tokens x = e_i +
    0.9·e_j, which pick experts {i, j}: the first 8 tokens all pick {0, 1},
    so an 8-token chunk of them drops half its assignments; the next 8 pick
    {0, 1} and {2, 3} in turn, so such a chunk fills every expert exactly
    to its capacity and drops none; the rest are drawn from a seed."""
    w = np.zeros((D, E4), np.float32)
    w[:E4, :E4] = 10 * np.eye(E4)
    rng = np.random.default_rng(7)
    pairs = [(0, 1)] * 8 + [(0, 1), (2, 3)] * 4 + [
        tuple(rng.choice(E4, 2, replace=False)) for _ in range(N_TOK - 16)]
    x = rng.normal(0, 0.01, (N_TOK, D)).astype(np.float32)
    for t, (i, j) in enumerate(pairs):
        x[t, i] += 1.0
        x[t, j] += 0.9
    return torch.from_numpy(w), torch.from_numpy(x)


@pytest.mark.parametrize("chunks", [1, 4, 8])
def test_routing_of_all_chunks_equals_chunk_by_chunk(chunks):
    """``route`` over (T, N_c, d) keeps the same assignments, with the same
    gates, tokens and slots within a chunk, as ``route`` on each chunk
    alone, exactly."""
    w, x = _chunk_case()
    kw = dict(n_experts=E4, top_k=2, capacity_factor=CHUNK_CF)
    nc = N_TOK // chunks
    r = moe.route(x.reshape(chunks, nc, D), w, **kw)
    assert r.chunks == chunks and r.counts.shape == (chunks, E4)
    nk = nc * 2
    drops = []
    for c in range(chunks):
        one = moe.route(x[c * nc:(c + 1) * nc], w, **kw)
        at = slice(c * nk, (c + 1) * nk)
        assert r.capacity == one.capacity
        assert torch.equal(r.probs[c], one.probs)
        assert torch.equal(r.counts[c], one.counts)
        assert torch.equal(r.order[at] - c * nk, one.order)
        assert torch.equal(r.token[at] - c * nc, one.token)
        assert torch.equal(r.gate[at], one.gate)
        assert torch.equal(r.keep[at], one.keep)
        expert, row = r.slot[at] // (chunks * r.capacity), r.slot[at] % (
            chunks * r.capacity)
        assert bool((row // r.capacity == c).all())
        assert torch.equal(expert * r.capacity + row % r.capacity, one.slot)
        drops.append(float(one.keep.sum()) < nk)
    if chunks == 8:                      # the first chunk drops, the next not
        assert drops[:2] == [True, False]


@pytest.mark.parametrize("chunks", [4, 8])
def test_moe_over_chunks_equals_its_chunks_one_by_one(chunks):
    """``moe(x, token_chunks=T)`` is the concatenation of ``moe`` on each
    chunk alone, and its ``aux`` their mean, with shared experts and
    padding experts and some chunks dropping assignments."""
    specs, kw, _ = _case("all at once")
    p = module.init_tree(specs, torch.Generator().manual_seed(2))
    kw = dict(kw, capacity_factor=0.75)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, D)).astype(np.float32))
    y, aux = moe.moe(p, x, **dict(kw, token_chunks=chunks))
    parts = [moe.moe(p, xc.reshape(1, -1, D), **dict(kw, token_chunks=1))
             for xc in x.reshape(-1, D).chunk(chunks)]
    want = torch.cat([o[0].reshape(-1, D) for o in parts]).reshape(B, S, D)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-7)
    want_aux = torch.mean(torch.stack([o[1] for o in parts]))
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


def test_aten_ops_of_one_call_do_not_grow_with_chunks():
    """One pass over every chunk: the ops one call dispatches are the same
    in number at 4 chunks and at 32."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    specs, kw, _ = _case("all at once")
    p = module.init_tree(specs, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, D)).astype(np.float32))
    counts = []
    for chunks in (4, 32):
        Count.n = 0
        with Count():
            moe.moe(p, x, **dict(kw, token_chunks=chunks))
        counts.append(Count.n)
    assert counts[0] == counts[1] and counts[0] < 200


# ---------------------------------------------------------------------------
# the models and the engine
# ---------------------------------------------------------------------------

def _models(ref, arch, dtype="float32"):
    rc = ref.registry.get_tiny(arch).replace(activation_dtype=dtype)
    pc = registry.get_tiny(arch).replace(activation_dtype=dtype)
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    rp = ref.module.init_tree(ref.tr.model_specs(rc), ref.jax.random.key(0))
    return rc, pc, rp, module.params_from_numpy(_np(rp))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_subtree_of_the_spec_tree_equals_reference(ref, arch):
    for get, ref_get in ((registry.get_config, ref.registry.get_config),
                         (registry.get_tiny, ref.registry.get_tiny)):
        port = transformer.model_specs(get(arch))["blocks"]["0"]["moe"]
        want = ref.tr.model_specs(ref_get(arch))["blocks"]["0"]["moe"]
        assert _spec_fields(port) == _spec_fields(want)
        assert ("shared" in port) == (arch == "qwen2-moe-a2.7b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_flops_per_token_equals_reference(ref, arch):
    for get, ref_get in ((registry.get_config, ref.registry.get_config),
                         (registry.get_tiny, ref.registry.get_tiny)):
        got = lm.model_flops_per_token(get(arch))
        assert got == ref.lm.model_flops_per_token(ref_get(arch))
        # the routed experts count at top_k of the padded experts
        assert got < 6 * module.param_count(transformer.model_specs(
            get(arch)))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_decode_equals_reference(ref, arch):
    """Eight greedy decode steps, each feeding the token the step chose,
    from a two-token prompt at fp32: the same tokens."""
    rc, pc, rp, pp = _models(ref, arch)
    toks = np.random.default_rng(5).integers(1, pc.vocab_size, (3, 2))
    outs = []
    for step, cache, tok, pos in (
            (ref.jax.jit(lambda t, c, p: ref.lm.serve_step(rc, rp, t, c,
                                                            p)),
             ref.tr.init_cache(rc, 3, 12), ref.jnp.asarray,
             lambda t: ref.jnp.full((3,), t, ref.jnp.int32)),
            (lambda t, c, p: lm.serve_step(pc, pp, t, c, p),
             transformer.init_cache(pc, 3, 12), torch.from_numpy,
             lambda t: torch.full((3,), t))):
        seq = [toks[:, 0:1], toks[:, 1:2]]
        for t in range(9):
            nxt, cache = step(tok(seq[t]), cache, pos(t))
            if t >= 1:
                seq.append(np.asarray(nxt).reshape(3, 1).astype(np.int64))
        outs.append(np.concatenate(seq[2:], axis=1))
    assert outs[0].shape == (3, 8)
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_equal_reference_at_fp32(ref, arch):
    """Six requests over three lanes, more requests than lanes: the port's
    engine gives the reference engine's token lists."""
    rc, pc, rp, pp = _models(ref, arch)
    requests = [([5, 6, 7, 8], 6), ([9, 10], 5), ([11, 12, 13], 7), ([1], 4),
                ([2, 3, 4, 5, 6, 7, 8], 3), ([30, 31], 8)]
    outs = []
    for eng in (ref.Engine(rc, rp, max_batch=3, max_len=32),
                ServingEngine(pc, pp, max_batch=3, max_len=32)):
        for prompt, n in requests:
            eng.submit(prompt, max_new_tokens=n)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
    assert outs[1] == outs[0]
    assert [len(outs[1][i]) for i in range(6)] == [n for _, n in requests]


def test_serve_moe_example_on_cpu():
    from repro_torch.examples import serve_moe
    finished = serve_moe.main(["--device", "cpu"])
    assert len(finished) == serve_moe.N_REQUESTS
    assert all(len(r.output) == serve_moe.NEW_TOKENS for r in finished)


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
@pytest.mark.parametrize("name", ["all at once", "tokens dropped"])
def test_moe_on_card_matches_its_cpu_run(cuda, name):
    specs, kw, x = _case(name)
    p = module.init_tree(specs, torch.Generator().manual_seed(0))
    want, want_aux = moe.moe(p, torch.from_numpy(x), **kw)
    got, aux = moe.moe(module.map_tree(lambda t: t.to(cuda), p),
                       torch.from_numpy(x).to(cuda), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-5


@pytest.mark.gpu
def test_moe_step_replays_equal_to_eager_at_bf16(cuda):
    """The layer at bf16 captured into a CUDA graph (no host sync inside):
    a replay on new tokens equals the eager layer value for value."""
    specs, kw, _ = _case("all at once")
    p = module.init_tree(specs, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    run = GraphRunner(lambda f: moe.moe(p, f["x"], **kw)[0], cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    xs = [torch.randn(B, S, D, generator=gen, device=cuda).bfloat16()
          for _ in range(3)]
    run({"x": xs[0]})                                # eager, then capture
    for x in xs[1:]:
        want = moe.moe(p, x, **kw)[0]
        got = run({"x": x})
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert len(run.replay_launches()) == 1
