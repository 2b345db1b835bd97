"""The port's LM continuous-batching engine and ``launch/serve``, on the
CPU.

At fp32 activations the engine's token lists equal the reference engine's
on the same numpy weights and prompts (the decode step matches the
reference's to ~1e-7 of the logit scale, far inside any gap between the
two best logits here).  The other tests mirror the reference's
``tests/test_serving.py``: draining more requests than lanes, tokens
independent of the traffic around a request, EOS, and lane reuse on
gemma2-tiny, whose rolling-window cache carries ``kpos`` sentinels, and
the lane reset itself.  On the card (``gpu``) the engine's ticks replay a
captured graph of the decode step, equal to the eager step's tokens and
cache.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.graphs import GraphRunner  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import module, transformer  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

#: (prompt, new tokens) per request: more requests than lanes, prompts of
#: one to seven tokens, one that runs into max_len
REQUESTS = [([5, 6, 7, 8], 6), ([9, 10], 5), ([11, 12, 13], 7), ([1], 4),
            ([2, 3, 4, 5, 6, 7, 8], 3), ([30, 31], 40)]


def _engine(arch="qwen2.5-3b", max_batch=3, max_len=32, **cfg_kw):
    cfg = registry.get_tiny(arch).replace(**cfg_kw)
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator().manual_seed(0))
    return ServingEngine(cfg, params, max_batch=max_batch, max_len=max_len)


def _outputs(engine) -> dict:
    return {r.rid: r.output for r in engine.run_until_drained()}


@pytest.fixture(scope="module")
def ref():
    """The reference package's engine and LM modules (they import JAX,
    which the card's machine does not have: the ``gpu`` test below does
    without them)."""
    jax = pytest.importorskip("jax")
    from repro.configs import registry as ref_registry
    from repro.nn import module as ref_module
    from repro.nn import transformer as ref_tr
    from repro.serving.engine import ServingEngine as RefEngine
    return jax, ref_registry, ref_module, ref_tr, RefEngine


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b"])
def test_engine_tokens_equal_reference_at_fp32(ref, arch):
    jax, ref_registry, ref_module, ref_tr, RefEngine = ref
    ref_cfg = ref_registry.get_tiny(arch).replace(activation_dtype="float32")
    cfg = registry.get_tiny(arch).replace(activation_dtype="float32")
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    ref_params = ref_module.init_tree(ref_tr.model_specs(ref_cfg),
                                      jax.random.key(0))
    params = module.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             ref_params))
    engines = (RefEngine(ref_cfg, ref_params, max_batch=3, max_len=32),
               ServingEngine(cfg, params, max_batch=3, max_len=32))
    outs = []
    for eng in engines:
        for prompt, n in REQUESTS:
            eng.submit(prompt, max_new_tokens=n)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
    assert outs[1] == outs[0]
    assert engines[1].stats()["ticks"] == engines[0].stats()["ticks"]
    assert engines[1].stats().keys() == engines[0].stats().keys()
    # the request that runs into max_len stops at its last position
    assert len(outs[1][5]) == 32 - 1 - (len(REQUESTS[5][0]) - 1)


def test_continuous_batching_drains_more_requests_than_lanes():
    eng = _engine(max_batch=2)
    rids = [eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(5)]
    finished = eng.run_until_drained()
    assert len(finished) == 5
    assert sorted(r.rid for r in finished) == rids
    for r in finished:
        assert isinstance(r, Request) and len(r.output) == 4
        assert r.ready and r.wait(timeout=0) == r.output
        assert r.first_token_t >= r.submit_t
    s = eng.stats()
    assert s["generated_tokens"] == 20 and s["requests"] == 5
    assert s["max_queue_depth"] == 5


def test_deterministic_outputs_independent_of_batching():
    """A request's tokens must not depend on lane traffic around it: alone
    in one lane, and packed among others in the same engine (the lanes it
    shares a step with, and the lane it lands in)."""
    eng1 = _engine(max_batch=1)
    eng1.submit([5, 6, 7, 8], max_new_tokens=6)
    alone = eng1.run_until_drained()[0].output

    eng2 = _engine(max_batch=3)
    eng2.submit([9, 10], max_new_tokens=6)
    eng2.submit([5, 6, 7, 8], max_new_tokens=6)
    eng2.submit([11, 12, 13], max_new_tokens=6)
    eng2.submit([5, 6, 7, 8], max_new_tokens=6)       # a reused lane
    packed = _outputs(eng2)
    assert packed[1] == alone and packed[3] == alone


def test_lane_reuse_resets_window_cache():
    """gemma2-tiny (window 8): a request long enough to wrap the rolling
    cache, then the first request again through the same lane, which must
    not see the earlier request's key positions."""
    eng = _engine("gemma2-27b", max_batch=1, max_len=48)
    eng.submit([3, 4, 5], max_new_tokens=5)
    first = eng.run_until_drained()[-1].output

    eng.submit([20, 21, 22, 23, 24, 25], max_new_tokens=9)
    eng.run_until_drained()
    eng.submit([3, 4, 5], max_new_tokens=5)
    again = eng.run_until_drained()[-1].output
    assert again == first


def test_reset_lane_cache_writes_init_values_into_one_lane():
    """A refilled lane's slice of every cache leaf holds its init values
    again (zeros, -1 for a rolling window's key positions, stacked and
    remainder layers), and the other lanes keep theirs."""
    eng = _engine("gemma2-27b", max_batch=2, max_len=16, n_layers=5)
    assert eng.cache["extra"]                       # a remainder layer
    for prompt in ([3, 4, 5, 6, 7], [8, 9]):
        eng.submit(prompt, max_new_tokens=12)
    eng.run_until_drained()
    before = module.map_tree(lambda a: a.clone(), eng.cache)
    eng._reset_lane_cache(1)
    for axis, part in ((1, "blocks"), (0, "extra")):
        for got, old, fresh in zip(module.tree_leaves(eng.cache[part]),
                                   module.tree_leaves(before[part]),
                                   module.tree_leaves(eng._fresh[part])):
            lane1 = got.narrow(axis, 1, 1)
            assert not torch.equal(old.narrow(axis, 1, 1), lane1)
            assert torch.equal(lane1, fresh)
            assert torch.equal(got.narrow(axis, 0, 1),
                               old.narrow(axis, 0, 1))


def test_eos_stops_generation():
    eng = _engine(max_batch=1)
    # pick eos as whatever the model emits first so it stops at length 1
    eng.submit([1, 2], max_new_tokens=8)
    tok = eng.run_until_drained()[0].output[0]
    eng2 = _engine(max_batch=1)
    eng2.submit([1, 2], max_new_tokens=8, eos_id=tok)
    out = eng2.run_until_drained()[0].output
    assert out[0] == tok and len(out) == 1


def test_empty_prompt_is_refused():
    with pytest.raises(ValueError, match="prompt"):
        _engine().submit([], max_new_tokens=2)


@pytest.mark.parametrize("argv", [
    ["--requests", "5"],
    ["--arch", "gemma2-27b", "--requests", "3", "--max-batch", "2",
     "--new-tokens", "6"],
    ["--arch", "qwen2-moe-a2.7b", "--requests", "3", "--max-batch", "2",
     "--new-tokens", "4"],
])
def test_serve_cli_on_cpu(argv, capsys):
    stats = serve.main(argv + ["--device", "cpu"])
    n = int(argv[argv.index("--requests") + 1])
    new = int(argv[argv.index("--new-tokens") + 1]) \
        if "--new-tokens" in argv else 16
    assert stats["requests"] == n and stats["generated_tokens"] == n * new
    assert "[serve]" in capsys.readouterr().out


def test_serve_cli_takes_no_tiny(monkeypatch):
    """``--no-tiny`` asks the registry for the published config (here a
    stand-in with the tiny width, so the CPU does not draw 3B weights)."""
    asked = []

    def get_config(arch):
        asked.append(arch)
        return registry.get_tiny(arch)

    monkeypatch.setattr(serve.registry, "get_config", get_config)
    stats = serve.main(["--no-tiny", "--requests", "2", "--device", "cpu"])
    assert asked == ["qwen2.5-3b"] and stats["requests"] == 2


def test_decode_step_feeds_keep_their_int64_dtype():
    """The engine's runner hands the step int64 tokens and positions, as
    the engine built them (on the CPU it runs the step eagerly on them)."""
    eng = _engine(max_batch=2)
    seen = []
    call = eng._step._call
    eng._step._call = lambda feeds: seen.append(
        {k: v.dtype for k, v in feeds.items()}) or call(feeds)
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run_until_drained()
    assert seen and all(s == {"tokens": torch.int64, "pos": torch.int64}
                        for s in seen)
    assert isinstance(eng._step, GraphRunner)
    assert eng._step.replay_launches() == {}          # nothing captured


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
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b",
                                  "qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_replayed_engine_equals_the_eager_engine_on_card(cuda, arch):
    """The same requests through the engine (one captured decode step,
    replayed every tick after the first) and through an engine whose step
    runs eagerly, at bf16 on the card: the same tokens, and the same
    cache value for value."""
    cfg = registry.get_tiny(arch)
    params = module.init_tree(transformer.model_specs(cfg),
                              torch.Generator(device=cuda).manual_seed(0),
                              device=cuda)
    engines = [ServingEngine(cfg, params, max_batch=3, max_len=32)
               for _ in range(2)]
    eager = engines[1]
    eager._step = lambda f: lm.serve_step(
        cfg, params, f["tokens"].to(cuda), eager.cache, f["pos"].to(cuda))[0]
    outs = []
    for eng in engines:
        for prompt, n in REQUESTS:
            eng.submit(prompt, max_new_tokens=n)
        outs.append({r.rid: r.output for r in eng.run_until_drained()})
    assert outs[0] == outs[1]
    assert len(engines[0]._step.replay_launches()) == 1
    for a, b in zip(module.tree_leaves(engines[0].cache),
                    module.tree_leaves(eager.cache)):
        assert torch.equal(a, b)
