"""The generic DFG tier, the ``simd`` backend and ``Design.verify`` of the
port, held against the reference package.

Both packages compile the same programs: the conv2d design (1, 3, 8, 8)
and BraggNN(s=1, img=9), the latter with the reference's
``init_params(PRNGKey(0))`` as numpy weights.  Inputs come from a numpy
seed.  On the CPU the DFG tier runs the segment kernel's plain PyTorch
version; the kernel itself runs in the ``gpu``-marked tests at the end.

* **Value for value** (``np.testing.assert_array_equal``: every output
  equal, NaN equal to NaN, a zero's sign not counted) against the numpy
  functional model ``repro.core.emit.evaluate``, at fp32, (5,4) and (5,3):
  the port rounds every op as ``evaluate`` does (fmac as two roundings).
* rtol 1e-5 / atol 1e-4 against the reference's jnp renderings (its DFG
  tier and its ``simd`` ``to_jax_fn``): XLA may contract the fmac into
  one rounding.  The reference's quantised DFG output is not used: its jnp
  quantiser leaves values off the lattice (fault R1 in ROADMAP.md).
"""

import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.core import emit, frontend, verify  # noqa: E402
from repro_torch.core.emit_cuda import (KernelPlan,  # noqa: E402
                                        _segment_layout, to_cuda_fn)
from repro_torch.core.precision import FORMATS  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.dfg_segment import ops as seg_ops  # noqa: E402
from repro_torch.kernels.dfg_segment.dfg_segment import (  # noqa: E402
    COL_GROUP, COL_RES_SLOT, COL_SLOT, COL_SRC, COL_UNIT, DESC_WIDTH,
    FLAG_DROPS, FLAG_ELIDED, FLAG_QUANT, FLAG_RECOMPUTE, FLAG_STAGE,
    MAX_SLOTS, dfg_segment)
from repro_torch.kernels.dfg_segment.ref import dfg_segment_ref  # noqa
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn.module import init_tree  # noqa: E402

#: against the reference's jnp renderings (XLA may fuse the fmac)
RTOL, ATOL = 1e-5, 1e-4
IMG, BATCH = 9, 4
FMTS = [None, "5_4", "5_3"]


def _conv_build(fe):
    def build(ctx):
        x = ctx.memref("input", (1, 3, 8, 8), "input")
        w = ctx.memref("weight", (4, 3, 3, 3), "weight")
        b = ctx.memref("bias", (4,), "weight")
        out = ctx.memref("out", (1, 4, 6, 6), "output")
        fe.conv2d(ctx, x, w, b, out)
    build.__name__ = "conv_dfg"
    return build


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    jax = pytest.importorskip("jax")
    import repro.hls
    from repro.core import emit as ref_emit
    from repro.core import emit_pallas
    from repro.core import frontend as ref_frontend
    from repro.core.precision import FORMATS as REF_FORMATS
    from repro.kernels import registry as ref_registry
    from repro.models import braggnn as ref_braggnn
    return types.SimpleNamespace(
        jax=jax, hls=repro.hls, emit=ref_emit, emit_pallas=emit_pallas,
        frontend=ref_frontend, FORMATS=REF_FORMATS, registry=ref_registry,
        braggnn=ref_braggnn)


@pytest.fixture(scope="module")
def conv(ref):
    """(reference design, port design, feeds of 3 samples)."""
    rd = ref.hls.Session().compile(_conv_build(ref.frontend))
    pd = hls.Session(device="cpu").compile(_conv_build(frontend))
    feeds = verify.random_feeds(pd.graph_raw, batch=3, seed=0)
    return rd, pd, feeds


@pytest.fixture(scope="module")
def bragg(ref):
    """(reference design, port design, feeds of BATCH samples)."""
    m = ref.braggnn.build(1, IMG)
    params = ref.jax.tree_util.tree_map(
        np.asarray, m.init_params(ref.jax.random.PRNGKey(0)))
    rd = ref.hls.Session().compile(m.bind(params))
    pd = hls.Session(device="cpu").compile(braggnn.build(
        1, IMG, params=braggnn.params_from_numpy(params)))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((BATCH, 1, 1, IMG, IMG)) * 0.2).astype(
        np.float32)
    return rd, pd, pd.feeds({"input": x})


@pytest.fixture(params=["conv", "bragg"])
def pair(request):
    return request.getfixturevalue(request.param)


def _fmt(ref, key):
    return ref.FORMATS[key] if key else None


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def _close(got: dict, want: dict) -> None:
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


def _np(out: dict) -> dict:
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# The DFG tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
def test_dfg_tier_equals_evaluate_value_for_value(ref, pair, fmt):
    rd, pd, feeds = pair
    want = ref.emit.evaluate(rd.graph_opt, feeds, fmt=_fmt(ref, fmt))
    fn = to_cuda_fn(pd.graph_opt, mode="dfg", fmt=fmt, device="cpu")
    got = fn(feeds)
    assert fn.plan.mode == "dfg" and fn.plan.fmt == fmt
    assert all(v.device.type == "cpu" for v in got.values())
    _equal(_np(got), want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_conv_dfg_tier_fp32_matches_reference(ref, conv, use_pallas):
    rd, pd, feeds = conv
    rfn = ref.emit_pallas.to_pallas_fn(rd.graph_opt, mode="dfg",
                                       use_pallas=use_pallas, interpret=True)
    fn = pd.torch_fn(backend="cuda", mode="dfg", device="cpu")
    _close(_np(fn(feeds)), rfn(feeds))


def test_bragg_dfg_tier_fp32_matches_reference(ref, bragg):
    rd, pd, feeds = bragg
    rfn = ref.emit_pallas.to_pallas_fn(rd.graph_opt, mode="dfg",
                                       use_pallas=False)
    fn = pd.torch_fn(backend="cuda", mode="dfg", device="cpu")
    _close(_np(fn(feeds)), rfn(feeds))


def _plan_fields(plan):
    return (plan.mode, plan.n_groups, plan.n_segments, plan.fused_scatters,
            plan.fallbacks, plan.kernels)


def test_dfg_plan_equals_reference(ref, pair):
    rd, pd, _ = pair
    rfn = ref.emit_pallas.to_pallas_fn(rd.graph_opt, mode="dfg",
                                       use_pallas=False)
    fn = to_cuda_fn(pd.graph_opt, mode="dfg", device="cpu")
    assert _plan_fields(fn.plan) == _plan_fields(rfn.plan)
    assert fn.plan.n_segments == 1 and fn.plan.fused_scatters > 0
    assert fn.plan.summary().startswith(
        f"cuda[dfg]; 1 fused kernels over {fn.plan.n_groups} groups "
        f"({fn.plan.fused_scatters} scatters elided); 0 fallbacks")


@pytest.mark.parametrize("fmt", [None, "5_4"])
def test_dfg_per_group_fallback_without_fmac(ref, conv, fmt):
    """Groups whose opcode is dropped from the table run as plain torch
    and are recorded, as the reference records them; values unchanged."""
    rd, pd, feeds = conv
    table = {k: v for k, v in registry.OPCODE_KERNELS.items()
             if k != "fmac"}
    ref_table = {k: v for k, v in ref.registry.OPCODE_KERNELS.items()
                 if k != "fmac"}
    rfn = ref.emit_pallas.to_pallas_fn(rd.graph_opt, mode="dfg",
                                       use_pallas=False,
                                       opcode_table=ref_table)
    fn = to_cuda_fn(pd.graph_opt, mode="dfg", device="cpu", fmt=fmt,
                    opcode_table=table)
    assert fn.plan.fallbacks and all("fmac" in f for f in fn.plan.fallbacks)
    assert _plan_fields(fn.plan) == _plan_fields(rfn.plan)
    _equal(_np(fn(feeds)), ref.emit.evaluate(rd.graph_opt, feeds,
                                             fmt=_fmt(ref, fmt)))


def test_raw_graph_cmpugt_select_fall_back(ref, bragg):
    """The raw (un-recomposed) graph's cmpugt/select groups are outside
    the opcode table: each is one recorded per-group fallback."""
    rd, pd, feeds = bragg
    rfn = ref.emit_pallas.to_pallas_fn(rd.graph_raw, mode="dfg",
                                       use_pallas=False)
    fn = to_cuda_fn(pd.graph_raw, mode="dfg", device="cpu")
    assert _plan_fields(fn.plan) == _plan_fields(rfn.plan)
    kinds = {f.split(":")[1].split(" ")[0] for f in fn.plan.fallbacks}
    assert kinds == {"cmpugt", "select"}
    _equal(_np(fn(feeds)), ref.emit.evaluate(rd.graph_raw, feeds))


def test_dfg_unbatched_feeds_broadcast(ref, conv):
    rd, pd, _ = conv
    feeds = verify.random_feeds(pd.graph_raw, batch=1, seed=3)
    unbatched = {k: v[0] for k, v in feeds.items()}
    want = ref.emit.evaluate(rd.graph_opt, unbatched)
    got = _np(to_cuda_fn(pd.graph_opt, mode="dfg", device="cpu")(unbatched))
    assert got["out"].shape == (1, 1, 4, 6, 6)
    _equal(got, want)
    _close(got, ref.emit_pallas.to_pallas_fn(
        rd.graph_opt, mode="dfg", use_pallas=False)(unbatched))


@pytest.mark.parametrize("fmt", [None, "5_4"])
def test_dfg_tier_serves_per_sample_weights(ref, bragg, fmt):
    """Weights that vary per sample, which the nest tier refuses."""
    rd, pd, _ = bragg
    feeds = verify.random_feeds(pd.graph_raw, batch=2, seed=1, scale=0.2)
    with pytest.raises(ValueError, match="varies across the batch"):
        pd.torch_fn(backend="cuda", device="cpu", weights=feeds)
    fn = pd.torch_fn(backend="cuda", device="cpu", mode="dfg", fmt=fmt)
    _equal(_np(fn(feeds)), ref.emit.evaluate(rd.graph_opt, feeds,
                                             fmt=_fmt(ref, fmt)))


def test_dfg_tier_binds_module_weights_once(ref, bragg):
    """Built from a design, the tier holds the module's weights on its
    device; per call only the input moves, and a feed of the same name
    takes precedence."""
    rd, pd, feeds = bragg
    fn = pd.torch_fn(backend="cuda", device="cpu", mode="dfg")
    assert fn.device == torch.device("cpu")
    got = fn({"input": torch.from_numpy(feeds["input"])})
    _equal(_np(got), ref.emit.evaluate(rd.graph_opt, feeds))
    zeroed = {**feeds,
              **{k: np.zeros_like(feeds[k])
                 for k in ("dense.3.bias", "dense.3.weight")}}
    assert not _np(fn(zeroed))["dense_3_out"].any()
    with pytest.raises(TypeError, match="feed dict"):
        fn(feeds["input"])


def test_serve_dfg_tier_quantised_equals_run(bragg):
    rd, pd, feeds = bragg
    x = feeds["input"]
    batches = [x[:, 0], torch.from_numpy(x[:3, 0]), {"input": x[:2]}]
    registry.reset_launch_counts()
    rep = pd.serve(batches, backend="cuda", fmt="5_4", device="cpu",
                   cuda_kw={"mode": "dfg"}, collect=True)
    assert rep.served.startswith("cuda[dfg]; 1 fused kernels over")
    assert rep.fallbacks == [] and (rep.batches, rep.samples) == (3, 9)
    assert not any(registry.launch_counts().values())   # plain versions
    for out, n in zip(rep.outputs, (4, 3, 2)):
        _equal(_np(out), pd.run(x[:n], fmt=FORMATS["5_4"]))


def _ref_segment(ref, g):
    """The reference planner's one segment of ``g`` (its own elisions and
    forwarding keys) and its plan."""
    rep = ref.emit_pallas
    groups = ref.emit.compile_groups(g.cols(), g.n_values)
    _, _, _, og = ref.emit.io_tables(g)
    outv = np.concatenate([v for v, _ in og.values()])
    plan = rep.PallasPlan(mode="dfg", use_pallas=False, interpret=False)
    (kind, seg), = rep._plan_segments(groups, outv,
                                      ref.registry.OPCODE_KERNELS, plan)
    return seg, plan


def test_segment_layout_and_plain_body_match_reference(ref, conv):
    """K4's plain version against the reference's ``_segment_body`` on one
    segment, with the reference's own elisions and forwarding: the same
    index vector, and the same whole buffer out (fp32), elided slots left
    as they were in both."""
    rd, pd, _ = conv
    g = rd.graph_opt
    seg, plan = _ref_segment(ref, g)
    assert plan.fused_scatters > 0
    body, want_idx = ref.emit_pallas._segment_body(
        seg, ref.registry.OPCODE_KERNELS, None, g.n_values)
    desc, idx = _segment_layout(seg, g.n_values, quant=False)
    np.testing.assert_array_equal(idx, want_idx)
    assert desc.shape[1] == DESC_WIDTH and len(desc) >= len(seg)
    groups = desc[:, COL_GROUP]
    assert sorted(set(groups.tolist())) == list(range(len(seg)))
    assert not (desc[:, 7] & FLAG_DROPS).any()   # every op has a result
    orig = (desc[:, 7] & FLAG_RECOMPUTE) == 0
    assert sorted(groups[orig].tolist()) == list(range(len(seg)))
    assert [bool(f & FLAG_ELIDED) for f, gi in zip(desc[orig, 7],
                                                   groups[orig])] \
        == [bool(seg[gi][4]) for gi in groups[orig]]
    quant, _ = _segment_layout(seg, g.n_values, quant=True)
    assert all(bool(f & FLAG_QUANT) == (seg[gi][0] not in ("load", "store",
                                                           "copy"))
               for f, gi in zip(quant[:, 7], quant[:, COL_GROUP]))
    buf = np.random.default_rng(5).standard_normal(
        (3, g.n_values)).astype(np.float32)
    want = np.asarray(body(ref.jax.numpy.asarray(buf),
                           ref.jax.numpy.asarray(want_idx)))
    got = seg_ops.segment(torch.from_numpy(buf.T.copy()),
                          torch.from_numpy(idx), torch.from_numpy(desc))
    np.testing.assert_allclose(got.numpy().T, want, rtol=RTOL, atol=ATOL)
    elided = np.concatenate([r for _oc, _a, r, _k, skip in seg if skip])
    np.testing.assert_array_equal(got.numpy()[elided], buf.T[elided])


def _stages(desc):
    """The entries of each stage, as lists of row indices."""
    out = []
    for i, f in enumerate(desc[:, 7]):
        if f & FLAG_STAGE or not out:
            out.append([])
        out[-1].append(i)
    return out


def _layout_of(ref, pair):
    rd, pd, _ = pair
    g = rd.graph_opt
    seg, _ = _ref_segment(ref, g)
    desc, idx = _segment_layout(seg, g.n_values, quant=False)
    return seg, desc, idx


def test_segment_stages_gather_nothing_their_own_entries_scatter(ref, pair):
    """Within a stage no entry gathers from the buffer a slot that an entry
    of the same stage scatters, so the kernel needs no barrier inside a
    stage; and a stage opens only where that would happen otherwise."""
    seg, desc, idx = _layout_of(ref, pair)
    stages = _stages(desc)
    assert 1 < len(stages) < len(seg)
    scattered_before = set()
    for rows in stages:
        gathered, scattered = set(), set()
        first = min(desc[i, COL_GROUP] for i in rows
                    if not desc[i, 7] & FLAG_RECOMPUTE)
        opens = False
        for i in rows:
            op, arity, *offs = desc[i, :5]
            n = desc[i, 6]
            for o, s, src in zip(offs[:arity],
                                 desc[i, COL_SLOT:COL_SLOT + 3],
                                 desc[i, COL_SRC:COL_SRC + 3]):
                if s < 0:
                    gathered.update(idx[o:o + n].tolist())
                if src < 0 and desc[i, COL_GROUP] == first:
                    opens |= bool(scattered_before
                                  & set(idx[o:o + n].tolist()))
            if not desc[i, 7] & FLAG_ELIDED:
                scattered.update(idx[desc[i, 5]:desc[i, 5] + n].tolist())
        assert not gathered & scattered
        # a stage opens where its first group gathers from the buffer a
        # slot that the stage before it scatters
        assert opens or not scattered_before
        scattered_before = scattered


def test_segment_forwarded_operands_come_from_their_stage_or_a_recompute(
        ref, pair):
    """Every operand the planner forwards is held per element from an
    entry of the consumer's unit that computes the producer (the producer
    itself, in the same stage, or a recompute of an elided producer of an
    earlier stage), or gathered from the buffer where the producer of an
    earlier stage was scattered.  Every planner key is honoured."""
    seg, desc, idx = _layout_of(ref, pair)
    stage_of = np.cumsum((desc[:, 7] & FLAG_STAGE) != 0)
    group_stage = {int(desc[i, COL_GROUP]): stage_of[i]
                   for i in range(len(desc))
                   if not desc[i, 7] & FLAG_RECOMPUTE}
    unit_start = 0
    routes = {"held": 0, "recomputed": 0, "buffer": 0}
    for i, row in enumerate(desc):
        if row[COL_UNIT]:
            unit_start = i
        gi = int(row[COL_GROUP])
        keys = seg[gi][3]
        for j in range(row[1]):
            src, slot = int(row[COL_SRC + j]), int(row[COL_SLOT + j])
            assert (src >= 0) == (keys[j] is not None)
            if src < 0:
                assert slot < 0
                continue
            assert np.array_equal(seg[src][2], seg[gi][1][j])
            if slot < 0:
                assert not seg[src][4]                 # scattered ...
                assert group_stage[src] < stage_of[i]  # ... earlier
                routes["buffer"] += 1
                continue
            holder = [k for k in range(unit_start, i)
                      if desc[k, COL_GROUP] == src
                      and desc[k, COL_RES_SLOT] == slot]
            assert holder, (i, j)
            if desc[holder[-1], 7] & FLAG_RECOMPUTE:
                assert seg[src][4] and group_stage[src] < stage_of[i]
                routes["recomputed"] += 1
            else:
                assert group_stage[src] == stage_of[i]
                routes["held"] += 1
    assert routes["held"] > 0
    assert desc[:, COL_RES_SLOT].max() < MAX_SLOTS


def test_dfg_plan_reports_its_stages(ref, pair):
    rd, pd, _ = pair
    _seg, desc, _ = _layout_of(ref, pair)
    fn = to_cuda_fn(pd.graph_opt, mode="dfg", device="cpu")
    (_idx, tdesc), = fn.segments
    np.testing.assert_array_equal(tdesc.numpy(), desc)
    assert fn.plan.n_stages == len(_stages(desc))
    assert fn.plan.summary().endswith(
        f"0 fallbacks; {fn.plan.n_stages} stages; plain versions (CPU "
        f"tensors)")


def test_dfg_runner_exposes_what_it_launches(ref, bragg):
    """The runner's own prologue and segment tables, run through the
    public segment wrapper, give the buffer its outputs are read from."""
    rd, pd, feeds = bragg
    fn = pd.torch_fn(backend="cuda", mode="dfg", fmt="5_4", device="cpu")
    (idx, desc), = fn.segments
    assert idx.dtype == torch.int32 and desc.shape[1] == DESC_WIDTH
    buf, batch = fn.prologue({"input": feeds["input"]})
    assert (tuple(buf.shape), batch) == ((pd.graph_opt.n_values, BATCH),
                                         BATCH)
    seg_ops.segment(buf, idx, desc, fmt=(5, 4))
    out = ref.emit.evaluate(rd.graph_opt, feeds, fmt=ref.FORMATS["5_4"])
    (name, vids), = ((k, v) for k, (v, _) in
                     emit.io_tables(pd.graph_opt)[3].items())
    np.testing.assert_array_equal(
        buf[torch.from_numpy(vids).long()].T.reshape(out[name].shape),
        out[name])


def _dangling_graph(ir):
    """A hand-built graph that reads a value nothing writes (``hole``):
    y = [(x0 + hole) * x1, max((x0 + hole) * x1, hole)]."""
    g = ir.Graph()
    x0, x1, hole = g.new_value(), g.new_value(), g.new_value()
    g.inputs["x"] = {(0,): x0, (1,): x1}
    a = g.add_op("addf", [x0, hole])
    b = g.add_op("mulf", [a, x1])
    c = g.add_op("maxf", [b, hole])
    g.outputs["y"] = {(0,): b, (1,): c}
    return g, hole


def test_prologue_zeroes_what_is_read_and_never_written(ref, monkeypatch):
    """The buffer comes uninitialised (here: NaN), and only the slots read
    but never written are zeroed, so the DFG tier and ``simd`` still read
    0 there, as ``evaluate`` does."""
    from repro.core import ir as ref_ir
    from repro_torch.core import ir
    g, hole = _dangling_graph(ir)
    rg, _ = _dangling_graph(ref_ir)
    assert emit.unwritten_reads(g).tolist() == [hole]
    feeds = {"x": np.array([[1.5, -2.0], [0.25, 3.0], [-1.0, 0.5]],
                           np.float32)}
    want = ref.emit.evaluate(rg, feeds)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: empty(*a, **k).fill_(float("nan")))
    fn = to_cuda_fn(g, mode="dfg", device="cpu")
    buf, _ = fn.prologue(feeds)
    assert buf[hole].eq(0).all() and buf.isnan().any()
    _equal(_np(fn(feeds)), want)
    _equal(_np(emit.to_torch_fn(g, backend="simd", device="cpu")(feeds)),
           want)


def test_braggnn_reads_nothing_unwritten(bragg):
    rd, pd, _ = bragg
    assert emit.unwritten_reads(pd.graph_opt).size == 0


def test_dfg_tier_rounds_bound_weights_once(ref, bragg, monkeypatch):
    """At (5,4) the constants and bound weights are rounded once, when the
    runner is built, as one table; per batch only the input feed goes
    through the quantiser."""
    from repro_torch.core import emit_cuda
    rd, pd, feeds = bragg
    calls = []
    quantize = emit_cuda.quantize

    def counting(x, fmt):
        calls.append(x.numel())
        return quantize(x, fmt)
    monkeypatch.setattr(emit_cuda, "quantize", counting)
    weights = {k: v for k, v in feeds.items() if k != "input"}
    fn = to_cuda_fn(pd.graph_opt, mode="dfg", fmt="5_4", device="cpu",
                    weights=weights)
    n_static = len(pd.graph_opt.consts) + sum(
        len(pd.graph_opt.inputs[k]) for k in weights)
    assert calls == [n_static]
    want = ref.emit.evaluate(rd.graph_opt, feeds, fmt=ref.FORMATS["5_4"])
    for _ in range(2):
        _equal(_np(fn({"input": feeds["input"]})), want)
    assert calls[1:] == [feeds["input"].size] * 2


@pytest.mark.parametrize("fmt", [None, "5_4"])
def test_dfg_tier_per_sample_weight_feed_overrides_bound(ref, bragg, fmt):
    """A feed of a bound weight's name, batched and varying per sample,
    takes the bound weight's place for that call only."""
    rd, pd, feeds = bragg
    fn = pd.torch_fn(backend="cuda", device="cpu", mode="dfg", fmt=fmt)
    w = feeds["dense.3.weight"]
    scale = np.random.default_rng(4).uniform(0.5, 1.5, (BATCH, 1, 1))
    per_sample = (w[None] * scale).astype(np.float32)
    over = {**feeds, "dense.3.weight": per_sample}
    got = _np(fn({"input": feeds["input"], "dense.3.weight": per_sample}))
    _equal(got, ref.emit.evaluate(rd.graph_opt, over, fmt=_fmt(ref, fmt)))
    bound = ref.emit.evaluate(rd.graph_opt, feeds, fmt=_fmt(ref, fmt))
    assert not np.array_equal(got["dense_3_out"], bound["dense_3_out"])
    _equal(_np(fn({"input": feeds["input"]})), bound)


def test_opcode_compute_renders_every_group_opcode():
    a = [torch.tensor([1.0, -2.0]), torch.tensor([0.5, 3.0]),
         torch.tensor([4.0, 5.0])]
    assert registry.opcode_compute("cmpugt", a[:2]).tolist() == [1.0, 0.0]
    assert registry.opcode_compute("select", a).tolist() == [0.5, 5.0]
    assert registry.opcode_compute("fmac", a).tolist() == [4.5, -1.0]
    with pytest.raises(NotImplementedError, match="frobf"):
        registry.opcode_compute("frobf", a)


def test_segment_plain_version_checks_its_table():
    buf = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="desc must be"):
        dfg_segment_ref(buf, torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        dfg_segment(buf, torch.zeros(1, dtype=torch.int32),
                    torch.zeros(1, DESC_WIDTH, dtype=torch.int32))


def test_kernel_plan_dfg_summary():
    plan = KernelPlan(mode="dfg", use_kernels=True, n_groups=138,
                      n_segments=1, fused_scatters=68)
    assert plan.summary() == ("cuda[dfg]; 1 fused kernels over 138 groups "
                              "(68 scatters elided); 0 fallbacks")


# ---------------------------------------------------------------------------
# The simd backend and Design.verify
# ---------------------------------------------------------------------------

def test_simd_equals_evaluate_value_for_value(ref, pair):
    rd, pd, feeds = pair
    fn = pd.torch_fn(backend="simd", device="cpu")
    assert fn is pd.torch_fn(backend="simd", device="cpu")   # cached
    _equal(_np(fn(feeds)), ref.emit.evaluate(rd.graph_opt, feeds))


def test_simd_matches_reference_to_jax_fn(ref, pair):
    rd, pd, feeds = pair
    with ref.jax.disable_jit():      # op by op: XLA's compile is slow here
        want = rd.jax_fn()(feeds)
    _close(_np(emit.to_torch_fn(pd.graph_opt, backend="simd",
                                device="cpu")(feeds)), want)


def test_simd_backend_contract(bragg):
    rd, pd, feeds = bragg
    with pytest.raises(TypeError, match="only device="):
        emit.to_torch_fn(pd.graph_opt, backend="simd", fmt="5_4")
    with pytest.raises(ValueError, match="runs fp32"):
        pd.serve([feeds["input"][:, 0]], backend="simd", fmt="5_4",
                 device="cpu")
    from repro_torch.hls import api
    assert "simd" in api.SERVE_BACKENDS
    pd.torch_fn(backend="simd", device="cpu")
    with pytest.raises(TypeError, match="only device="):   # also when cached
        pd.compiled.torch_fn(backend="simd", device="cpu", fmt="5_4")
    clone = pickle.loads(pickle.dumps(pd.compiled))
    assert clone._simd_fns == {} and pd.compiled._simd_fns


def test_serve_simd_backend(bragg):
    rd, pd, feeds = bragg
    x = feeds["input"]
    rep = pd.serve([x[:, 0], x[:3, 0]], backend="simd", device="cpu",
                   collect=True)
    assert (rep.backend, rep.batches, rep.samples) == ("simd", 2, 7)
    _equal(_np(rep.outputs[1]), pd.run(x[:3]))


def test_design_verify_matches_reference(ref, pair):
    rd, pd, _ = pair
    with ref.jax.disable_jit():      # op by op: XLA's compile is slow here
        want = rd.verify()
    got = pd.verify(device="cpu")
    for f in ("n_ops_raw", "n_ops_opt", "makespan", "max_abs_err_opt",
              "max_abs_err_ref", "max_abs_err_quant", "passed"):
        assert getattr(got, f) == getattr(want, f), f
    assert abs(got.max_abs_err_simd - want.max_abs_err_jax) <= 1e-6
    assert got.name == want.name
    assert "err(simd)" in got.summary()


def test_design_verify_with_fmt_and_reference_fn(ref, conv):
    rd, pd, _ = conv

    def ref_fn(feeds):
        return pd.run(feeds, raw=True)

    kw = {"fmt": FORMATS["5_4"], "seed": 3}
    got = pd.verify(device="cpu", ref_fn=ref_fn, **kw)
    want = rd.verify(ref_fn=ref_fn, fmt=ref.FORMATS["5_4"], seed=3)
    assert got.passed and got.max_abs_err_ref == 0.0
    assert got.max_abs_err_quant == want.max_abs_err_quant > 0.0


def test_run_testbench_compiles_a_build_function():
    rep = verify.run_testbench("conv_tb", _conv_build(frontend),
                               device="cpu", batch=2)
    assert rep.passed and rep.n_ops_opt < rep.n_ops_raw
    with pytest.raises(ValueError, match="build= or design="):
        verify.run_testbench("none", device="cpu")


# ---------------------------------------------------------------------------
# On the card: the segment kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def port_bragg(cuda):
    """BraggNN(s=1, img=9) with seeded weights, from the port alone (the
    card's machine has no JAX)."""
    m = braggnn.build(1, IMG)
    d = hls.Session(device="cpu").compile(
        m.bind(init_tree(m.specs(), torch.Generator().manual_seed(0))))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((BATCH, 1, 1, IMG, IMG)) * 0.2).astype(
        np.float32)
    return d, d.feeds({"input": x})


#: batches on the card: one sample, a slab's ragged part (3, 17), the
#: ragged 100 the serving checks use, and 256
CARD_BATCHES = [1, 3, 17, 100, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", CARD_BATCHES)
@pytest.mark.parametrize("fmt", FMTS)
def test_segment_kernel_equals_plain_on_card(cuda, port_bragg, fmt, batch):
    """The segment the DFG tier's runner launches, on a random buffer:
    kernel and plain version equal value for value over the whole buffer
    (elided slots untouched by both), in one launch."""
    from repro_torch.kernels.dfg_segment.dfg_segment import (launch_shape,
                                                             value_buffer)
    d, _ = port_bragg
    fn = d.torch_fn(backend="cuda", mode="dfg", fmt=fmt, device=cuda)
    (idx, desc), = fn.segments
    f = FORMATS[fmt] if fmt else None
    kw = {"fmt": (f.exp_bits, f.man_bits) if f else None}
    rnd = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (d.graph_opt.n_values, batch)).astype(np.float32) * 0.5).to(cuda)

    def fresh():
        return value_buffer(*rnd.shape, cuda).copy_(rnd)
    before = dfg_segment.launches
    got = dfg_segment(fresh(), idx, desc, **kw)
    assert dfg_segment.launches == before + 1
    want = dfg_segment_ref(fresh(), idx, desc.cpu(), **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if batch % 4:
        with pytest.raises(ValueError, match="start on 16 bytes"):
            dfg_segment(rnd.clone(), idx, desc, **kw)
    shape = launch_shape(batch)
    assert shape["slab"] >= 8 and shape["active_clusters"] >= 1
    assert -(-batch // shape["slab"]) <= max(shape["active_clusters"], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", CARD_BATCHES)
@pytest.mark.parametrize("fmt", FMTS)
def test_dfg_tier_on_card_equals_evaluate(cuda, port_bragg, fmt, batch):
    d, _ = port_bragg
    fn = d.torch_fn(backend="cuda", mode="dfg", fmt=fmt, device=cuda)
    assert fn.plan.use_kernels
    rng = np.random.default_rng(batch)
    x = (rng.standard_normal((batch, 1, 1, IMG, IMG)) * 0.2).astype(
        np.float32)
    registry.reset_launch_counts()
    got = fn({"input": x})
    assert registry.launch_counts()["dfg_segment"] == 1
    _equal({k: v.cpu().numpy() for k, v in got.items()},
           d.run(d.feeds({"input": x}), fmt=FORMATS[fmt] if fmt else None))
