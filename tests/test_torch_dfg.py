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
    DESC_WIDTH, FLAG_QUANT, dfg_segment)
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


def test_segment_layout_and_plain_body_match_reference(ref, conv):
    """K4's plain version against the reference's ``_segment_body`` on one
    segment: the same index vector, and the same buffer out (fp32).  The
    port scatters every group, so the reference body is given the segment
    with no scatter elided (it still forwards), and whole buffers agree."""
    rd, pd, _ = conv
    rep = ref.emit_pallas
    g = rd.graph_opt
    groups = ref.emit.compile_groups(g.cols(), g.n_values)
    _, _, _, og = ref.emit.io_tables(g)
    outv = np.concatenate([v for v, _ in og.values()])
    plan = rep.PallasPlan(mode="dfg", use_pallas=False, interpret=False)
    (kind, seg), = rep._plan_segments(groups, outv,
                                      ref.registry.OPCODE_KERNELS, plan)
    assert plan.fused_scatters > 0
    every = [(oc, a, r, keys, False) for oc, a, r, keys, _skip in seg]
    body, want_idx = rep._segment_body(every, ref.registry.OPCODE_KERNELS,
                                       None, g.n_values)
    desc, idx = _segment_layout(seg, g.n_values, quant=False)
    np.testing.assert_array_equal(idx, want_idx)
    assert desc.shape == (len(seg), DESC_WIDTH)
    assert not desc[:, 7].any()            # fp32, every op has a result
    quant, _ = _segment_layout(seg, g.n_values, quant=True)
    assert all((f == FLAG_QUANT) == (s[0] not in ("load", "store", "copy"))
               for f, s in zip(quant[:, 7], seg))
    buf = np.random.default_rng(5).standard_normal(
        (3, g.n_values)).astype(np.float32)
    want = np.asarray(body(ref.jax.numpy.asarray(buf),
                           ref.jax.numpy.asarray(want_idx)))
    got = seg_ops.segment(torch.from_numpy(buf.T.copy()),
                          torch.from_numpy(idx), torch.from_numpy(desc))
    np.testing.assert_allclose(got.numpy().T, want, rtol=RTOL, atol=ATOL)


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


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_segment_kernel_equals_plain_on_card(cuda, port_bragg, fmt):
    """The segment the DFG tier's runner launches, on a random buffer:
    kernel and plain version equal value for value over the whole buffer."""
    d, _ = port_bragg
    fn = d.torch_fn(backend="cuda", mode="dfg", fmt=fmt, device=cuda)
    (idx, desc), = fn.segments
    f = FORMATS[fmt] if fmt else None
    kw = {"fmt": (f.exp_bits, f.man_bits) if f else None}
    buf = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (d.graph_opt.n_values, 100)).astype(np.float32) * 0.5).to(cuda)
    before = dfg_segment.launches
    got = dfg_segment(buf.clone(), idx, desc, **kw)
    assert dfg_segment.launches == before + 1
    want = dfg_segment_ref(buf.clone(), idx, desc, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", FMTS)
def test_dfg_tier_on_card_equals_evaluate(cuda, port_bragg, fmt):
    d, feeds = port_bragg
    fn = d.torch_fn(backend="cuda", mode="dfg", fmt=fmt, device=cuda)
    assert fn.plan.use_kernels
    registry.reset_launch_counts()
    got = fn(feeds)
    assert registry.launch_counts()["dfg_segment"] == 1
    _equal({k: v.cpu().numpy() for k, v in got.items()},
           d.run(feeds, fmt=FORMATS[fmt] if fmt else None))
