"""The slice end to end: BraggNN compiled by the port and served through
the nest tier, held against the reference package.

Both packages get the reference's ``init_params(PRNGKey(0))`` as numpy
weights and the same numpy inputs.  On the CPU the port's nest tier runs
its kernels' plain PyTorch versions (the kernels themselves run on the
card, in the ``gpu``-marked test at the end).  Tolerances:

* fp32, rtol 1e-4 / atol 1e-5: the same lowering, summed in another order
  by another framework;
* (5,4), one (5,4) ulp at the output's scale: the reference's jnp
  quantiser leaves values off the lattice (fault R1 in ROADMAP.md), which
  can move a rounding by one step.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.core import device as devices  # noqa: E402
from repro_torch.core import verify  # noqa: E402
from repro_torch.core.emit_cuda import KernelPlan, to_cuda_fn  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn import graph as nng  # noqa: E402
from repro_torch.nn.module import init_tree  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
IMG, BATCH = 9, 4
PLAN = {"conv2d_vmem": 2, "conv2d_vmem:relu": 2, "fused_softmax": 1,
        "smallfloat_matmul:relu": 4}


def _ulp_5_4(scale: float) -> float:
    """One (5,4) ulp at magnitude ``scale``."""
    return 2.0 ** (np.floor(np.log2(max(scale, 2.0 ** -14))) - 4)


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    jax = pytest.importorskip("jax")
    import repro.hls
    from repro.core.emit_pallas import to_pallas_fn
    from repro.models import braggnn as ref_braggnn
    from repro.nn import graph as ref_nng
    return types.SimpleNamespace(jax=jax, hls=repro.hls, braggnn=ref_braggnn,
                                 nng=ref_nng, to_pallas_fn=to_pallas_fn)


@pytest.fixture(scope="module")
def params(ref):
    m = ref.braggnn.build(1, IMG)
    return ref.jax.tree_util.tree_map(
        np.asarray, m.init_params(ref.jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_design(ref, params):
    return ref.hls.Session().compile(ref.braggnn.build(1, IMG).bind(params))


@pytest.fixture(scope="module")
def design(params):
    return hls.Session(device="cpu").compile(braggnn.build(
        1, IMG, params=braggnn.params_from_numpy(params)))


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((BATCH, 1, 1, IMG, IMG)) * 0.2).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The nest tier against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_nest_tier_fp32_matches_reference(ref_design, design, x,
                                          use_pallas):
    rfn = ref_design.jax_fn(backend="pallas", use_pallas=use_pallas,
                            interpret=True)
    want = rfn(ref_design.feeds({"input": x}))
    fn = design.torch_fn(backend="cuda", device="cpu")
    got = fn({"input": x})
    assert fn.plan.kernels == rfn.plan.kernels == PLAN
    assert fn.plan.fallbacks == rfn.plan.fallbacks == []
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_nest_tier_5_4_matches_reference(ref_design, design, x, use_pallas):
    rfn = ref_design.jax_fn(backend="pallas", use_pallas=use_pallas,
                            interpret=True, fmt="5_4")
    want = rfn(ref_design.feeds({"input": x}))
    fn = design.torch_fn(backend="cuda", device="cpu", fmt="5_4")
    got = fn(x)
    assert fn.plan.fmt == rfn.plan.fmt == "5_4"
    assert fn.plan.kernels == rfn.plan.kernels
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=_ulp_5_4(float(np.abs(w).max())))


def test_nest_tier_leaves_the_rounding_to_the_kernels(design, x,
                                                     monkeypatch):
    """At (5,4) BraggNN's steps round every result inside a kernel (conv
    and matmul epilogues, the softmax's read of the scores), so the tier
    itself calls the elementwise quantiser not once."""
    from repro_torch.core import emit_cuda
    calls, real = [], emit_cuda.quantize

    def counting(t, fmt):
        calls.append(tuple(t.shape))
        return real(t, fmt)

    monkeypatch.setattr(emit_cuda, "quantize", counting)
    fn = design.torch_fn(backend="cuda", device="cpu", fmt="5_4")
    fn(x)
    assert calls == []


@pytest.mark.parametrize("fmt,cuda_kw", [(None, {}), ("5_4", {}),
                                         (None, {"nlb_flash": True})])
def test_nest_runner_launches_the_dense_chain_once_per_batch(
        ref_design, design, x, monkeypatch, fmt, cuda_kw):
    """BraggNN's four Linear layers (each with its ReLU) go to the K3
    chain wrapper as one chain of four, once per batch; the plan still
    records them layer by layer, as the reference's does."""
    from repro_torch.kernels.smallfloat_matmul import ops as mm_ops
    calls, real = [], mm_ops.matmul_chain

    def counting(xx, layers, **kw):
        calls.append([tuple(ly.w.shape) for ly in layers])
        return real(xx, layers, **kw)

    monkeypatch.setattr(mm_ops, "matmul_chain", counting)
    fn = design.torch_fn(backend="cuda", device="cpu", fmt=fmt, **cuda_kw)
    rfn = ref_design.jax_fn(backend="pallas", use_pallas=False, fmt=fmt,
                            **cuda_kw)
    assert fn.plan.kernels == rfn.plan.kernels
    assert fn.plan.kernels["smallfloat_matmul:relu"] == 4
    fn(x)
    fn(x[:3])
    chain = [(50 if IMG == 11 else 18, 16), (16, 8), (8, 4), (4, 2)]
    assert calls == [chain, chain]


def test_a_run_the_chain_does_not_take_goes_as_chains_of_one(monkeypatch):
    """An inner width over 256 is decided at build, from the shapes: each
    Linear is then a chain of one."""
    from repro_torch.kernels.smallfloat_matmul import ops as mm_ops
    m = nng.ModuleGraph("wide", (1, 1, 4, 4), [
        nng.Flatten(out_name_="flat"),
        nng.Linear("d0", in_features=16, out_features=300),
        nng.ReLU(out_name_="r0"),
        nng.Linear("d1", in_features=300, out_features=2)])
    m = m.bind(init_tree(m.specs(), torch.Generator().manual_seed(0)))
    calls, real = [], mm_ops.matmul_chain

    def counting(xx, layers, **kw):
        calls.append(len(layers))
        return real(xx, layers, **kw)

    monkeypatch.setattr(mm_ops, "matmul_chain", counting)
    fn = to_cuda_fn(None, module=m, device="cpu")
    xs = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (3, 1, 1, 4, 4)).astype(np.float32))
    got = next(iter(fn(xs).values()))
    assert calls == [1, 1]
    assert fn.plan.kernels == {"smallfloat_matmul:relu": 1,
                               "smallfloat_matmul": 1}
    w = m.weight_feeds()
    h = torch.relu(xs.reshape(3, 16) @ torch.as_tensor(w["d0.weight"]).T
                   + torch.as_tensor(w["d0.bias"]))
    want = h @ torch.as_tensor(w["d1.weight"]).T + torch.as_tensor(
        w["d1.bias"])
    np.testing.assert_allclose(got.reshape(3, 2).numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_nest_tier_fp32_matches_evaluate(design, x):
    want = design.run(x)
    got = design.torch_fn(backend="cuda", device="cpu")(x)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("fmt", [None, "5_11", "5_4", "5_3"])
def test_tensor_backend_matches_reference(ref_design, design, x, fmt):
    want = ref_design.serve([x[:, 0]], backend="tensor", fmt=fmt,
                            collect=True).outputs[0]
    got = design.serve([x[:, 0]], backend="tensor", fmt=fmt,
                       collect=True).outputs[0]
    want = np.asarray(want)
    atol = _ulp_5_4(float(np.abs(want).max())) if fmt else ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0 if fmt else RTOL,
                               atol=atol)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def test_serve_cuda_backend_on_cpu(design, x):
    batches = [x[:, 0], x[:, 0], torch.from_numpy(x[:3, 0])]   # ragged
    seen = []
    registry.reset_launch_counts()
    rep = design.serve(batches, backend="cuda", device="cpu", collect=True,
                       on_batch=lambda i, out: seen.append(i))
    assert isinstance(rep, hls.ServeReport)
    assert rep.backend == "cuda" and rep.device == "cpu"
    assert rep.fallbacks == []
    assert rep.served.startswith("cuda[nests]") and "0 fallbacks" in \
        rep.served
    assert (rep.batches, rep.samples, seen) == (3, 11, [0, 1, 2])
    assert rep.p50_ms > 0 and rep.us_per_sample > 0
    assert "served 11 samples in 3 batches" in rep.summary()
    # the CPU runs the plain versions: no kernel launched
    assert not any(registry.launch_counts().values())
    want = design.run(x[:3])
    for k in want:
        np.testing.assert_allclose(rep.outputs[2][k].numpy(), want[k],
                                   rtol=RTOL, atol=ATOL)


def test_serve_rejects_unknown_backend(design, x):
    with pytest.raises(ValueError, match="expected one of"):
        design.serve([x[:, 0]], backend="pallas")


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        devices.resolve()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hls.Session()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hls.compile(braggnn.build(1, 7))


def test_runner_binds_weights_once_and_reads_only_the_input(design, x):
    fn = design.torch_fn(backend="cuda", device="cpu")
    assert fn.device == torch.device("cpu")
    one = fn(x[0])                                   # an unbatched sample
    assert one["dense_3_out"].shape == (1, 1, 2)
    natural = fn(torch.from_numpy(x[:, 0]))          # (B, C, H, W)
    assert torch.equal(natural["dense_3_out"], fn(x)["dense_3_out"])
    with pytest.raises(ValueError, match="reads only the input memref"):
        fn(design.feeds(x))


def test_nest_tier_rejects_per_sample_weights(design):
    feeds = verify.random_feeds(design.graph_raw, batch=2, seed=1)
    with pytest.raises(ValueError, match="varies across the batch"):
        design.torch_fn(backend="cuda", device="cpu", weights=feeds)
    same = {k: np.stack([v, v]) for k, v in design.feeds(
        np.zeros((1, 1, IMG, IMG), np.float32)).items()}
    design.torch_fn(backend="cuda", device="cpu", weights=same)


def test_design_report_and_feeds(design, x):
    text = design.report()
    assert "device   : cpu" in text and design.design_hash[:12] in text
    feeds = design.feeds(x)
    assert feeds["input"].shape == x.shape and "conv1.weight" in feeds


# ---------------------------------------------------------------------------
# Fallback steps and what waits for later slices
# ---------------------------------------------------------------------------

def _vocab_nodes(ng):
    return [ng.Conv2d("c1", in_channels=1, out_channels=2, kernel=3),
            ng.BatchNorm2d("bn", channels=2),
            ng.ReLU(name="r1"),
            ng.Conv2d("c2", in_channels=2, out_channels=2, kernel=3,
                      padding=1),
            ng.MaxPool2d(name="mp", kernel=2, stride=2),
            ng.Flatten(name="fl"),
            ng.Linear("fc", in_features=2 * 3 * 3, out_features=4),
            ng.Softmax(name="sm")]


@pytest.mark.parametrize("fmt", [None, "5_4"])
def test_fallback_steps_match_reference(ref, fmt):
    ref_m = ref.nng.ModuleGraph("vocab", (1, 1, 8, 8),
                                _vocab_nodes(ref.nng))
    p = ref.jax.tree_util.tree_map(np.asarray,
                                   ref_m.init_params(ref.jax.random.key(1)))
    p["bn"]["mean"] = np.full(2, 0.1, np.float32)
    p["bn"]["var"] = np.full(2, 0.5, np.float32)
    ref_m = ref_m.bind(p)
    m = nng.ModuleGraph("vocab", (1, 1, 8, 8), _vocab_nodes(nng),
                        params=braggnn.params_from_numpy(p))
    xs = np.random.default_rng(2).normal(0, 0.5, (3, 1, 1, 8, 8)).astype(
        np.float32)
    rfn = ref.to_pallas_fn(None, module=ref_m, fmt=fmt)
    want = rfn({"input": xs, **ref_m.weight_feeds()})
    fn = to_cuda_fn(None, module=m, fmt=fmt, device="cpu")
    got = fn(xs)
    assert fn.plan.kernels == rfn.plan.kernels
    assert [f.split(":")[0] for f in fn.plan.fallbacks] == \
        [f.split(":")[0] for f in rfn.plan.fallbacks] == ["bn", "c2", "mp"]
    for k in want:
        w = np.asarray(want[k])
        atol = _ulp_5_4(float(np.abs(w).max())) if fmt else ATOL
        np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=atol)


def test_transformer_steps_and_flash_mode_wait_for_their_slices(ref, design):
    """The transformer slice has landed: an Attention-only graph lowers
    through the nest tier with the reference's kernel counts, with the
    Taylor softmax and in the flash mode."""
    def attn(ng, params=None):
        return ng.ModuleGraph("attn", (4, 8), [
            ng.Attention("attn", d_model=8, n_heads=2, pre_norm=False)],
            params=params)
    p = ref.jax.tree_util.tree_map(
        np.asarray, attn(ref.nng).init_params(ref.jax.random.PRNGKey(0)))
    for kw in ({}, {"nlb_flash": True}):
        fn = to_cuda_fn(None, module=attn(nng, braggnn.params_from_numpy(p)),
                        device="cpu", **kw)
        rfn = ref.to_pallas_fn(None, module=attn(ref.nng, p), **kw)
        assert fn.plan.kernels == rfn.plan.kernels
        assert fn.plan.kernels["smallfloat_matmul"] == 1
        assert fn.plan.fallbacks == rfn.plan.fallbacks == []
    assert "flash_attention" in fn.plan.kernels
    # K5 has landed: the NLB flash-attention mode builds
    fn = design.torch_fn(backend="cuda", device="cpu", nlb_flash=True)
    assert fn.plan.kernels["flash_attention"] == 1
    assert "fused_softmax" not in fn.plan.kernels


def test_kernel_plan_summary_and_fields():
    plan = KernelPlan(mode="nests", use_kernels=False, fmt="5_4")
    plan.record_kernel("conv2d_vmem")
    plan.record_kernel("conv2d_vmem")
    assert plan.kernels == {"conv2d_vmem": 2}
    assert plan.summary() == ("cuda[nests]; conv2d_vmemx2; 0 fallbacks; "
                              "plain versions (CPU tensors)")


# ---------------------------------------------------------------------------
# The model module
# ---------------------------------------------------------------------------

def test_params_round_trip_through_feeds(ref, design, params):
    feeds = {k: v[None] for k, v in design.feeds(
        np.zeros((1, 1, IMG, IMG), np.float32)).items() if k != "input"}
    tree = braggnn.params_from_feeds(feeds)
    flat = ref.jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == 18
    for path, leaf in flat:
        node = tree
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_seeded_init_and_synthetic_peaks_are_reproducible():
    specs = braggnn.specs(1, 11)
    a = init_tree(specs, torch.Generator().manual_seed(0))
    b = init_tree(specs, torch.Generator().manual_seed(0))
    assert torch.equal(a["conv2a"]["w"], b["conv2a"]["w"])
    assert a["conv1"]["b"].abs().sum() == 0          # zeros init, as in JAX
    imgs, labels = braggnn.synthetic_peaks(
        5, 11, torch.Generator().manual_seed(3))
    imgs2, _ = braggnn.synthetic_peaks(5, 11,
                                       torch.Generator().manual_seed(3))
    assert imgs.shape == (5, 1, 11, 11) and labels.shape == (5, 2)
    assert torch.equal(imgs, imgs2)
    assert bool(((labels > 0) & (labels < 1)).all())


# ---------------------------------------------------------------------------
# On the card: the slice through the CUDA kernels
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_slice_on_card_matches_evaluate_and_launches_kernels(x):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = braggnn.build(1, IMG)
    d = hls.compile(m.bind(init_tree(m.specs(),
                                     torch.Generator().manual_seed(0))))
    batches = [x[:, 0], x[:3, 0]]
    registry.reset_launch_counts()
    rep = d.serve(batches, backend="cuda", collect=True)
    # the four dense layers are one chain launch per batch (and one more
    # for the warm-up run)
    assert registry.launch_counts() == {"conv2d_vmem": 21,
                                        "dfg_segment": 0,
                                        "flash_attention": 0,
                                        "fused_softmax": 3,
                                        "slstm_scan": 0,
                                        "slstm_scan_backward": 0,
                                        "smallfloat_matmul": 3}
    for out, xb in zip(rep.outputs, batches):
        want = d.run(xb)
        for k in want:
            np.testing.assert_allclose(out[k].cpu().numpy(), want[k],
                                       rtol=RTOL, atol=ATOL)
