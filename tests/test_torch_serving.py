"""The port's serving tier: the request engine, warm-boot artifacts, and the
runner that replays a captured CUDA graph per batch shape.

Mirrors the engine and artifact contracts of ``tests/test_serving.py`` on
the port, and holds the port's engine against the reference's.  Both
packages get the reference's ``init_params(PRNGKey(0))`` as numpy weights
and the same numpy samples; the port runs on the CPU (``device="cpu"``),
where the runner is eager and the kernels run their plain versions.
Engine outputs on ``tensor`` and on ``cuda`` match the reference engine's
(``tensor``, and ``pallas`` through its jnp oracles) within rtol 1e-5 /
atol 1e-6: one model summed in another order by another framework.  The
``gpu``-marked tests at the end hold the captured graphs to the eager
runner value for value on the card.
"""

import pickle
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.core import device as devices  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.pipeline import ARTIFACT_MAGIC  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn.module import init_tree  # noqa: E402
from repro_torch.runtime.fault import FailureInjector  # noqa: E402
from repro_torch.serving import (DesignEngine, EngineReport,  # noqa: E402
                                 default_buckets)

IMG = 7
#: port engine vs the reference's: the same model, another framework
RTOL, ATOL = 1e-5, 1e-6
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    jax = pytest.importorskip("jax")
    import repro.hls
    from repro.models import braggnn as ref_braggnn
    from repro.serving import design_engine
    return types.SimpleNamespace(jax=jax, hls=repro.hls,
                                 braggnn=ref_braggnn, engine=design_engine)


@pytest.fixture(scope="module")
def params(ref):
    m = ref.braggnn.build(1, IMG)
    return ref.jax.tree_util.tree_map(
        np.asarray, m.init_params(ref.jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_design(ref, params):
    return ref.hls.Session().compile(ref.braggnn.build(1, IMG).bind(params),
                                     name="braggnn_engine")


@pytest.fixture(scope="module")
def bound_design(params):
    return hls.Session(device="cpu").compile(braggnn.build(
        1, IMG, params=braggnn.params_from_numpy(params)),
        name="braggnn_engine")


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(0)
    return [rng.normal(0.0, 0.25, (1, 1, IMG, IMG)).astype(np.float32)
            for _ in range(9)]


def _drain(engine, xs):
    reqs = [engine.submit(x) for x in xs]
    engine.run_until_drained()
    return [r.wait(timeout=30) for r in reqs]


def _assert_same(a, b):
    """Bit-identity across array outputs (tensor) or memref dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _only(out):
    """The one output of a memref dict (or the array itself)."""
    if isinstance(out, dict):
        (v,) = out.values()
        return np.asarray(v)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# DesignEngine: adaptive batching over a compiled Design
# ---------------------------------------------------------------------------

def test_default_buckets(ref):
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(12) == (1, 2, 4, 8, 12)
    assert default_buckets(1) == (1,)
    with pytest.raises(ValueError):
        default_buckets(0)
    for n in (1, 3, 32, 100, 256):
        assert default_buckets(n) == ref.engine.default_buckets(n)


def test_engine_sync_mode_serves_all_requests(bound_design, samples):
    eng = bound_design.engine(backend="tensor", max_batch=4)
    outs = _drain(eng, samples)
    rep = eng.report()
    assert isinstance(rep, EngineReport)
    assert rep.completed == len(samples) and rep.dropped == 0
    assert all(np.asarray(o).shape == (2,) for o in outs)
    # head-of-queue grouping: 9 requests, max_batch 4 -> 4+4+1
    assert sorted(rep.batch_hist.items()) == [(1, 1), (4, 2)]
    assert rep.p95_ms >= rep.p50_ms >= 0.0


@pytest.mark.parametrize("backend,cuda_kw", [
    ("tensor", None), ("cuda", None), ("cuda", {"mode": "dfg"}),
    ("simd", None)])
def test_engine_matches_design_serve(bound_design, samples, backend,
                                     cuda_kw):
    """Engine per-sample outputs == the port's own sync ``Design.serve``
    outputs, bit for bit (one (9,) dispatch, the serve batch's shape)."""
    eng = bound_design.engine(backend=backend, cuda_kw=cuda_kw,
                              buckets=(len(samples),))
    outs = _drain(eng, samples)
    batch = np.concatenate(samples)          # (9, 1, IMG, IMG)
    report = bound_design.serve([batch], backend=backend, device="cpu",
                                cuda_kw=cuda_kw, collect=True)
    ref = _only(report.outputs[0])
    for i, o in enumerate(outs):
        assert isinstance(_only(o), np.ndarray)
        np.testing.assert_array_equal(_only(o), ref[i])


@pytest.mark.parametrize("backend,ref_backend,ref_kw", [
    ("tensor", "tensor", None),
    ("cuda", "pallas", {"use_pallas": False})])
def test_engine_outputs_match_reference_engine(ref_design, bound_design,
                                               samples, backend, ref_backend,
                                               ref_kw):
    want = _drain(ref_design.engine(backend=ref_backend, max_batch=4,
                                    pallas_kw=ref_kw), samples)
    eng = bound_design.engine(backend=backend, max_batch=4)
    got = _drain(eng, samples)
    assert sorted(eng.report().batch_hist.items()) == [(1, 1), (4, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_only(g).reshape(-1),
                                   _only(w).reshape(-1), rtol=RTOL,
                                   atol=ATOL)


def test_engine_padding_counts_bucket_fill(bound_design, samples):
    eng = bound_design.engine(backend="tensor", buckets=(4,))
    _drain(eng, samples[:3])
    rep = eng.report()
    assert rep.batch_hist == {4: 1}
    assert rep.padded_samples == 1


def test_engine_threaded_mode_drains_on_stop(bound_design, samples):
    eng = bound_design.engine(backend="simd", max_batch=4, max_delay_ms=1.0)
    with eng:
        reqs = [eng.submit(x) for x in samples]
        outs = [r.wait(timeout=30) for r in reqs]
    rep = eng.report()
    assert rep.completed == len(samples) and rep.dropped == 0
    assert rep.qps > 0
    # the SIMD design returns its output memrefs as a dict, sliced per sample
    assert all(np.asarray(o["dense_3_out"]).shape == (1, 2) for o in outs)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(samples[0])


def test_engine_rejects_bad_sample_shape(bound_design):
    eng = bound_design.engine(backend="tensor", max_batch=2)
    with pytest.raises(ValueError, match="does not match input memref"):
        eng.submit(np.zeros((3, 3), np.float32))


def test_engine_default_backend_follows_serve(bound_design):
    """``tensor`` when the design has a bound tensor twin, else ``cuda``
    (the reference falls back to ``simd``; the port to its kernels)."""
    assert bound_design.engine(max_batch=2).backend == "tensor"
    bare = hls.Session(device="cpu").compile(braggnn.build(1, IMG).bind(
        init_tree(braggnn.specs(1, IMG), torch.Generator().manual_seed(0))))
    bare._module.forward_fn = None
    eng = DesignEngine(bare, max_batch=2)
    assert eng.backend == "cuda" and eng.device.type == "cpu"
    assert eng.report().served.startswith("cuda[nests]")


def test_engine_restart_releases_the_old_replicas_graphs(
        bound_design, samples, monkeypatch):
    released = []
    real = graphs.GraphRunner.release

    def counting(self):
        released.append(self)
        real(self)

    monkeypatch.setattr(graphs.GraphRunner, "release", counting)
    eng = bound_design.engine(backend="cuda", max_batch=4,
                              injector=FailureInjector(fail_at=(1,)))
    first = eng._run_one.graphs
    _drain(eng, samples)
    assert eng.report().restarts == 1
    assert released == [first]
    assert eng._run_one.graphs is not first


# ---------------------------------------------------------------------------
# Warm-boot artifacts: Design.save / hls.load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["tensor", "simd", "cuda"])
def test_save_load_round_trip_bit_identical(bound_design, samples,
                                            tmp_path, backend):
    path = tmp_path / "bragg.design"
    bound_design.save(path, backend=backend)
    ref = _drain(bound_design.engine(backend=backend, max_batch=4), samples)

    loaded = hls.load(path, device="cpu")
    assert loaded.manifest["backend"] == backend
    assert loaded.manifest["path"] == str(path)
    assert loaded.device.type == "cpu"
    eng = loaded.engine(max_batch=4)         # backend from the manifest
    assert eng.backend == backend
    outs = _drain(eng, samples)
    for a, b in zip(ref, outs):
        _assert_same(a, b)


def test_save_stores_params_as_numpy_and_load_binds_them(bound_design,
                                                         tmp_path):
    path = tmp_path / "bragg.design"
    bound_design.save(path)
    raw = path.read_bytes()
    header, _, body = raw.partition(b"\n")
    assert header.decode().startswith(ARTIFACT_MAGIC + " v")
    record = pickle.loads(body)
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]
    flat = leaves(record["module"].params)
    assert len(flat) == 18 and all(type(v) is np.ndarray for v in flat)
    loaded = hls.load(path, device="cpu")
    w = loaded.module.params["conv1"]["w"]
    assert isinstance(w, torch.Tensor) and w.device.type == "cpu"
    assert torch.equal(w, bound_design.module.params["conv1"]["w"])
    # the manifest defaults: 32-wide buckets, the design's identity
    assert loaded.manifest["buckets"] == list(default_buckets(32))
    assert loaded.manifest["design_hash"] == bound_design.design_hash


def test_load_rejects_non_artifact(tmp_path):
    p = tmp_path / "junk.design"
    p.write_bytes(pickle.dumps({"nope": 1}))
    with pytest.raises(ValueError, match="not a repro_torch design artifact"):
        hls.load(p, device="cpu")
    with pytest.raises(FileNotFoundError):
        hls.load(tmp_path / "missing.design", device="cpu")
    stale = tmp_path / "stale.design"
    stale.write_bytes(f"{ARTIFACT_MAGIC} v0\n".encode()
                      + pickle.dumps({"design": None}))
    with pytest.raises(ValueError, match="format v0"):
        hls.load(stale, device="cpu")


def test_load_refuses_a_reference_artifact_without_importing_it(
        ref_design, tmp_path):
    """A ``repro.hls`` artifact raises ``ValueError`` from its header, and
    the loading process imports neither ``repro`` nor ``jax``."""
    path = tmp_path / "reference.design"
    ref_design.save(path)
    code = (
        "import sys\n"
        "import repro_torch.hls as hls\n"
        "try:\n"
        f"    hls.load({str(path)!r}, device='cpu')\n"
        "    print('LOADED')\n"
        "except ValueError as e:\n"
        "    print('VALUEERROR', e)\n"
        "bad = sorted(m for m in sys.modules if m in ('repro', 'jax')\n"
        "             or m.startswith(('repro.', 'jax.')))\n"
        "print('MODULES', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin"},
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("VALUEERROR") and str(path) in lines[0]
    assert "not a repro_torch design artifact" in lines[0]
    assert lines[1] == "MODULES []"


# ---------------------------------------------------------------------------
# Fault tolerance: poisoned dispatch -> artifact warm re-boot, zero dropped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["tensor", "cuda"])
def test_fault_injection_restarts_from_artifact_no_request_lost(
        bound_design, samples, tmp_path, backend):
    path = tmp_path / "bragg.design"
    bound_design.save(path, backend=backend)

    # uninterrupted reference run
    ref = _drain(bound_design.engine(backend=backend, max_batch=4,
                                     artifact_path=path), samples)

    # poison dispatch 1: the second batch fails mid-stream
    inj = FailureInjector(fail_at=(1,))
    eng = bound_design.engine(backend=backend, max_batch=4,
                              artifact_path=path, injector=inj)
    outs = _drain(eng, samples)
    rep = eng.report()
    assert inj.fired == [1]
    assert rep.restarts == 1
    assert rep.boots == ["memory", "artifact"]   # re-booted from the file
    assert rep.dropped == 0
    assert rep.retried == 4                      # the failed batch, requeued
    assert rep.completed == len(samples)
    for a, b in zip(ref, outs):                  # bit-identical recovery
        _assert_same(a, b)


def test_fault_exhausted_retries_fail_requests_not_hang(bound_design,
                                                        samples):
    inj = FailureInjector(fail_at=(0, 1, 2))
    eng = bound_design.engine(backend="tensor", max_batch=4, max_retries=2,
                              injector=inj)
    reqs = [eng.submit(x) for x in samples[:4]]
    eng.run_until_drained()
    rep = eng.report()
    assert rep.restarts == 3
    assert rep.dropped == 4                      # failed after max_retries
    for r in reqs:
        with pytest.raises(RuntimeError, match="injected failure"):
            r.wait(timeout=5)


def test_watchdog_and_injector_are_the_references(ref):
    """The port's copies behave as the reference's on the same traces."""
    from repro.runtime.fault import FailureInjector as RefInjector
    from repro.runtime.fault import StepWatchdog as RefWatchdog
    from repro_torch.runtime.fault import StepWatchdog
    durations = [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.2, 0.95, 4.0, 1.0]
    ours, theirs = StepWatchdog(), RefWatchdog()
    flags = [(ours.observe(i, d), theirs.observe(i, d))
             for i, d in enumerate(durations)]
    assert all(a == b for a, b in flags)
    assert ours.stragglers == theirs.stragglers == [4, 8]
    a, b = FailureInjector(fail_at=(2, 5)), RefInjector(fail_at=(2, 5))
    for step in range(7):
        for inj in (a, b):
            try:
                inj.check(step)
            except RuntimeError:
                pass
    assert a.fired == b.fired == [2, 5]


# ---------------------------------------------------------------------------
# ServeReport percentiles and queue-depth telemetry
# ---------------------------------------------------------------------------

def test_serve_report_has_percentiles(bound_design, samples):
    batch = np.concatenate(samples)
    report = bound_design.serve([batch] * 5, backend="tensor")
    assert report.p99_ms >= report.p95_ms >= report.p50_ms > 0.0
    assert "p50" in report.summary()


def test_queue_depth_counts_idle_and_ramp_periods(bound_design, samples):
    """A burst of 8 queued requests must report a max depth of 8 and a
    time-weighted mean/p95 near the top, even though dispatch-time
    sampling alone would see the queue only as it drains (mean ~4)."""
    eng = bound_design.engine(backend="tensor", buckets=(1,))
    for x in samples[:8]:
        eng.submit(x)
    time.sleep(0.25)          # the queue sits at depth 8 the whole time
    eng.run_until_drained()
    rep = eng.report()
    assert rep.completed == 8
    assert rep.max_queue_depth == 8
    # the dwell at depth 8 dominates the drain transitions
    assert rep.p95_queue_depth >= 7
    assert rep.mean_queue_depth > 5


def _threads_in_a_new_thread() -> int:
    got = []
    t = threading.Thread(target=lambda: got.append(torch.get_num_threads()))
    t.start()
    t.join()
    return got[0]


@pytest.fixture
def pool_of_two_or_more():
    """torch's intra-op pool at >= 2 threads for the test, then as it was."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(before, 2))
    yield torch.get_num_threads()
    torch.set_num_threads(before)


def test_small_cpu_batches_run_on_one_thread_and_overlaps_restore_the_pool(
        pool_of_two_or_more):
    """host_threads in two threads, A in, B in, A out, B out: each runs
    on one thread inside, and afterwards the process (this thread and a
    thread started later) has its pool back; a batch at the cutoff, or on
    no device, keeps the pool."""
    pool = pool_of_two_or_more
    cpu = torch.device("cpu")
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    inside = {}

    def a():
        with devices.host_threads(cpu, 1, serial_below=2):
            inside["a"] = torch.get_num_threads()
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with devices.host_threads(cpu, 1, serial_below=2):
            inside["b"] = torch.get_num_threads()
            b_in.set()
            a_out.wait(10)

    ts = [threading.Thread(target=f) for f in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert inside == {"a": 1, "b": 1}
    assert torch.get_num_threads() == pool
    assert _threads_in_a_new_thread() == pool
    with devices.host_threads(cpu, 2, serial_below=2):
        assert torch.get_num_threads() == pool
    with devices.host_threads(None, 1, serial_below=2):
        assert torch.get_num_threads() == pool


def test_two_engines_draining_at_once_keep_the_thread_pool(
        bound_design, samples, pool_of_two_or_more):
    """Two threaded engines serving single-sample batches at once leave
    torch's intra-op pool as they found it."""
    engines = [bound_design.engine(backend="tensor", buckets=(1,))
               for _ in range(2)]
    for eng in engines:
        eng.start()
    for x in samples[:8]:
        for eng in engines:
            eng.submit(x)
    for eng in engines:
        eng.stop()
    assert [eng.report().completed for eng in engines] == [8, 8]
    assert torch.get_num_threads() == pool_of_two_or_more
    assert _threads_in_a_new_thread() == pool_of_two_or_more


# ---------------------------------------------------------------------------
# The runner: eager on the CPU, one captured graph per shape on the card
# ---------------------------------------------------------------------------

def test_runner_on_the_cpu_is_eager_and_captures_nothing(bound_design,
                                                         samples):
    run_one, _, _ = bound_design._runner("cuda", None, torch.device("cpu"),
                                         None)
    batch = np.concatenate(samples)
    a, b = run_one(batch), run_one(batch)
    assert run_one.graphs.replay_launches() == {}
    # eager: each call returns fresh outputs
    assert a["dense_3_out"].data_ptr() != b["dense_3_out"].data_ptr()
    assert torch.equal(a["dense_3_out"], b["dense_3_out"])


#: every serving path the runner captures: (backend, fmt, cuda_kw)
CARD_PATHS = [("cuda", None, None), ("cuda", "5_4", None),
              ("cuda", None, {"nlb_flash": True}),
              ("cuda", None, {"mode": "dfg"}),
              ("cuda", "5_4", {"mode": "dfg"}),
              ("simd", None, None), ("tensor", None, None),
              ("tensor", "5_4", None)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_design(cuda):
    """BraggNN(s=1, img=9) with seeded weights, from the port alone (the
    card's machine has no JAX)."""
    m = braggnn.build(1, 9)
    return hls.Session(device=cuda).compile(
        m.bind(init_tree(m.specs(), torch.Generator().manual_seed(0))))


def _card_batch(b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, 1, 9, 9)) * 0.2).astype(np.float32)


def _tensors(out):
    return out if isinstance(out, dict) else {"out": out}


@pytest.mark.gpu
@pytest.mark.parametrize("backend,fmt,cuda_kw", CARD_PATHS)
def test_replayed_graph_equals_eager_runner_on_card(cuda, card_design,
                                                    backend, fmt, cuda_kw):
    """Per batch shape: the first call runs eagerly and captures; a replay
    on new data equals a fresh eager run value for value, and launches
    what an eager batch launches."""
    run_one, _, _ = card_design._runner(backend, fmt, cuda, cuda_kw)
    for b in (17, 4):
        run_one(_card_batch(b, 0))                     # capture
        x = _card_batch(b, 1)
        registry.reset_launch_counts()
        want = {k: v.clone() for k, v in _tensors(run_one.eager(x)).items()}
        torch.cuda.synchronize()
        eager_counts = registry.launch_counts()
        registry.reset_launch_counts()
        got = _tensors(run_one(x))
        torch.cuda.synchronize()
        assert registry.launch_counts() == eager_counts
        assert len(run_one.graphs.replay_launches()) == (1 if b == 17 else 2)
        for k in want:
            assert torch.equal(got[k], want[k]), (k, b)
    if backend == "cuda":
        assert any(n for c in run_one.graphs.replay_launches().values()
                   for n in c.values())
    run_one.release()
    assert run_one.graphs.replay_launches() == {}


@pytest.mark.gpu
def test_collected_batches_do_not_alias_on_card(cuda, card_design):
    xs = [_card_batch(8, s) for s in (1, 2, 3)]
    rep = card_design.serve(xs, backend="cuda", collect=True)
    outs = [o["dense_3_out"] for o in rep.outputs]
    ptrs = {o.data_ptr() for o in outs}
    assert len(ptrs) == len(outs)
    assert not torch.equal(outs[0], outs[1])
    for o, x in zip(outs, xs):
        want = card_design.run(x)["dense_3_out"]
        np.testing.assert_allclose(o.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.gpu
def test_engine_on_card_equals_serve_and_restarts_without_a_leak(
        cuda, card_design, tmp_path):
    xs = [_card_batch(1, s)[0] for s in range(40)]
    batch = np.concatenate(xs)
    want = card_design.serve([batch], backend="cuda",
                             collect=True).outputs[0]["dense_3_out"]
    path = tmp_path / "card.design"
    card_design.save(path, backend="cuda")
    eng = card_design.engine(backend="cuda", buckets=(len(xs),),
                             artifact_path=path)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda)
    eng.injector = FailureInjector(fail_at=(0,))
    outs = _drain(eng, xs)
    rep = eng.report()
    assert rep.boots == ["memory", "artifact"] and rep.dropped == 0
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o["dense_3_out"],
                                      want[i].cpu().numpy())
    torch.cuda.synchronize()
    # the old replica's graphs are gone: one set of pools, not two
    assert torch.cuda.memory_allocated(cuda) <= held * 1.05 + (1 << 20)
