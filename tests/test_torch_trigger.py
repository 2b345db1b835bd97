"""The port's trigger: part catalog, budget checks and the streaming loop.

Mirrors every contract of ``tests/test_trigger.py`` on the port (at the
reference's margins for the realtime tests), and holds the port to the
reference: ``DetectorFeed`` frames bitwise, ``check_budget`` row for row,
and the loop's scores within rtol 1e-5 / atol 1e-6 with its decisions
equal wherever a score is more than 1e-4 * max(1, |threshold|) from the
threshold.  Both packages get the reference's ``init_params(PRNGKey(0))``
as numpy weights; the port runs on the CPU (``device="cpu"``).
"""

import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch import obs, trigger  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn.module import init_tree  # noqa: E402
from repro_torch.serving.common import DropOldestRing  # noqa: E402

IMG = 7
#: port scores vs the reference's: the same model, another framework
RTOL, ATOL = 1e-5, 1e-6
#: a decision may differ only this close to the threshold (relative)
DECISION_BAND = 1e-4


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()


@pytest.fixture
def one_thread():
    """The realtime tests hold the loop to the wall clock: one torch thread
    keeps each window's CPU run out of contention with the thread pools of
    other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    jax = pytest.importorskip("jax")
    import repro.hls
    from repro import trigger as ref_trigger
    from repro.models import braggnn as ref_braggnn
    return types.SimpleNamespace(jax=jax, hls=repro.hls,
                                 braggnn=ref_braggnn, trigger=ref_trigger)


@pytest.fixture(scope="module")
def params(ref):
    m = ref.braggnn.build(1, IMG)
    return ref.jax.tree_util.tree_map(
        np.asarray, m.init_params(ref.jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def ref_design(ref, params):
    return ref.hls.Session().compile(ref.braggnn.build(1, IMG).bind(params),
                                     name="braggnn_trig")


@pytest.fixture(scope="module")
def design(params):
    """One small bound BraggNN design shared by the loop tests."""
    return hls.Session(device="cpu").compile(braggnn.build(
        1, IMG, params=braggnn.params_from_numpy(params)),
        name="braggnn_trig")


# -- parts -------------------------------------------------------------------


def test_part_caps_speak_schedule_vocabulary():
    caps = trigger.alveo_u280.caps()
    assert caps["DSP"] == 9024
    assert caps["BRAM_ports"] == 2 * 2016          # ports, not blocks
    assert set(caps) <= {"DSP", "FF", "BRAM_ports", "LUT_units"}
    assert trigger.zcu102.caps()["DSP"] == 2520
    # synthetic parts constrain only what they name
    assert trigger.part(dsp=16).caps() == {"DSP": 16}


def test_part_catalog_equals_reference(ref):
    assert sorted(trigger.PARTS) == sorted(ref.trigger.PARTS)
    for name, p in trigger.PARTS.items():
        assert p.caps() == ref.trigger.PARTS[name].caps()


def test_get_part_resolves_and_rejects():
    assert trigger.get_part("alveo_u280") is trigger.alveo_u280
    assert trigger.get_part(None) is None
    p = trigger.part(dsp=4, name="tiny")
    assert trigger.get_part(p) is p
    with pytest.raises(KeyError, match="unknown part"):
        trigger.get_part("virtex_2000")


# -- budgets -----------------------------------------------------------------


def test_budget_caps_merge_and_margin_validation():
    b = trigger.TriggerBudget(part="zcu102", max_dsp=100)
    caps = b.resource_caps()
    assert caps["DSP"] == 100                      # explicit beats the part
    assert caps["FF"] == trigger.zcu102.caps()["FF"]
    with pytest.raises(ValueError, match="margin"):
        trigger.TriggerBudget(margin=1.0)
    with pytest.raises(KeyError, match="unknown part"):
        trigger.TriggerBudget(part="nope")         # typo fails eagerly
    # key() is a stable identity for tuning-context hashing
    assert b.key() == trigger.TriggerBudget(part="zcu102", max_dsp=100).key()
    assert b.key() != trigger.TriggerBudget(part="zcu102").key()


def test_check_design_both_sides(design):
    ok = design.check_budget(part="alveo_u280")
    assert ok.passed and ok.failures == []
    assert ok.check("DSP").used == design.schedule.resources()["DSP"]
    assert "PASS" in ok.summary()
    assert ok.raise_if_failed() is ok

    bad = design.check_budget(part=trigger.part(dsp=16))
    assert not bad.passed
    assert bad.failures == ["DSP"]                 # named offender
    assert "FAIL" in bad.summary() and "DSP" in bad.summary()
    with pytest.raises(trigger.BudgetError, match="DSP"):
        bad.raise_if_failed()
    j = bad.to_json()
    assert j["passed"] is False and j["failures"] == ["DSP"]


def _rows(rep):
    return [(c.name, c.used, c.cap, c.ok) for c in rep.checks]


@pytest.mark.parametrize("case", ["u280", "zcu102", "dsp16", "latency",
                                  "margin"])
def test_check_budget_equals_reference(ref, ref_design, design, case):
    """The same checks (name, used, cap, passed) for the same design."""
    lat = design.sample_latency_us
    dsp = design.schedule.resources()["DSP"]

    def args(t):
        return {"u280": ((None,), {"part": "alveo_u280"}),
                "zcu102": ((None,), {"part": "zcu102"}),
                "dsp16": ((None,), {"part": t.part(dsp=16)}),
                "latency": ((t.TriggerBudget(max_latency_us=lat / 2,
                                             max_ii=3),), {}),
                "margin": ((t.TriggerBudget(part=t.part(dsp=dsp),
                                            margin=0.1),), {})}[case]
    a, kw = args(trigger)
    ra, rkw = args(ref.trigger)
    got = design.check_budget(*a, **kw)
    want = ref_design.check_budget(*ra, **rkw)
    assert _rows(got) == _rows(want)
    assert got.passed == want.passed and got.failures == want.failures


def test_budget_latency_ii_and_margin(design):
    lat = design.sample_latency_us
    tight = trigger.TriggerBudget(max_latency_us=lat / 2)
    rep = design.check_budget(tight)
    assert rep.failures == ["latency_us"]
    loose = trigger.TriggerBudget(max_latency_us=lat * 2, max_ii=10 ** 9)
    assert design.check_budget(loose).passed

    # margin shrinks resource caps: exactly-at-cap fails with headroom
    dsp = design.schedule.resources()["DSP"]
    at_cap = trigger.TriggerBudget(part=trigger.part(dsp=dsp))
    assert design.check_budget(at_cap).passed
    with_headroom = trigger.TriggerBudget(part=trigger.part(dsp=dsp),
                                          margin=0.1)
    assert design.check_budget(with_headroom).failures == ["DSP"]


def test_check_budget_requires_an_envelope(design):
    with pytest.raises(ValueError, match="TriggerBudget"):
        design.check_budget()


def test_report_budget_section_and_summary_latency(design):
    assert "us/sample" in design.summary()         # surfaced, not buried
    rep = design.report(part="alveo_u280")
    assert "budget check [PASS]" in rep
    rep2 = design.report(part=trigger.part(dsp=1))
    assert "FAIL" in rep2 and "DSP" in rep2


# -- the ring ----------------------------------------------------------------


def test_ring_drop_oldest_overrun():
    ring = DropOldestRing(3)
    assert [ring.push(i) for i in range(3)] == [None, None, None]
    assert ring.push(3) == 0                       # oldest evicted, returned
    assert ring.push(4) == 1
    assert ring.dropped == 2 and ring.pushed == 5
    assert ring.pop_many(10) == [2, 3, 4]          # survivors oldest-first
    assert ring.pop() is None
    with pytest.raises(ValueError, match="capacity"):
        DropOldestRing(0)


def test_ring_drops_count_in_obs():
    obs.enable()
    ring = DropOldestRing(1)
    ring.push("a")
    ring.push("b")
    assert obs.snapshot()["counters"]["trigger.dropped_frames"] == 1.0


# -- the feed ----------------------------------------------------------------


def test_feed_deterministic_and_pileup_bursts():
    mk = lambda: trigger.DetectorFeed(img=IMG, seed=5, event_rate=0.5,
                                      pileup_every=10, pileup_len=3,
                                      pileup_peaks=4)
    a, b = list(mk().frames(25)), list(mk().frames(25))
    assert all(np.array_equal(x.data, y.data) for x, y in zip(a, b))
    assert [f.n_peaks for f in a] == [f.n_peaks for f in b]
    # bursts: frames 0-2, 10-12, 20-22 carry pileup_peaks each
    for i in (0, 1, 2, 10, 11, 12, 20, 21, 22):
        assert a[i].n_peaks == 4
    # outside the bursts the event rate is Bernoulli 0/1
    assert set(f.n_peaks for f in a[3:10]) <= {0, 1}
    assert a[0].data.shape == (1, 1, IMG, IMG)
    assert a[0].data.dtype == np.float32
    # arrival schedule follows the configured rate
    assert a[2].t_sched == pytest.approx(2 / mk().frame_rate_hz)


@pytest.mark.parametrize("kw", [
    {"img": IMG, "seed": 5, "event_rate": 0.5, "pileup_every": 10,
     "pileup_len": 3, "pileup_peaks": 4},
    {"img": 11, "seed": 11},
    {"img": 9, "seed": 0, "frame_rate_hz": 2000, "noise": 0.1}])
def test_feed_frames_equal_reference_bitwise(ref, kw):
    got = list(trigger.DetectorFeed(**kw).frames(120))
    want = list(ref.trigger.DetectorFeed(**kw).frames(120))
    assert any(f.n_peaks > 1 for f in got)          # a pileup burst
    assert trigger.DetectorFeed(**kw).describe() == \
        ref.trigger.DetectorFeed(**kw).describe()
    for g, w in zip(got, want):
        assert (g.frame_id, g.n_peaks, g.t_sched) == \
            (w.frame_id, w.n_peaks, w.t_sched)
        assert g.data.dtype == w.data.dtype
        assert g.data.tobytes() == w.data.tobytes()


# -- the loop ----------------------------------------------------------------


def test_loop_decisions_bit_identical_across_runs(design):
    def once():
        loop = design.trigger(backend="tensor", window=4)
        loop.calibrate(trigger.DetectorFeed(img=IMG, seed=9), 32)
        rep = loop.run(trigger.DetectorFeed(img=IMG, seed=9), 50)
        return loop.threshold, rep

    th1, r1 = once()
    th2, r2 = once()
    assert th1 == th2
    assert r1.processed == r1.frames == 50
    assert r1.dropped == 0                         # deterministic mode
    assert 0 < r1.accepts < 50                     # calibrated split
    assert [(d.frame_id, d.accept, d.score) for d in r1.decisions] == \
           [(d.frame_id, d.accept, d.score) for d in r2.decisions]
    # every frame decided exactly once, in order
    assert [d.frame_id for d in r1.decisions] == list(range(50))


@pytest.mark.parametrize("backend,ref_backend,ref_kw,window", [
    ("tensor", "tensor", None, 4), ("cuda", "pallas",
                                    {"use_pallas": False}, 1),
    ("cuda", "pallas", {"use_pallas": False}, 4)])
def test_loop_scores_match_reference(ref, ref_design, design, backend,
                                     ref_backend, ref_kw, window):
    """Scores within rtol 1e-5 / atol 1e-6 of the reference loop's at an
    explicit threshold (the reference's calibrated one, handed to both);
    decisions equal outside the band around it."""
    threshold = ref_design.trigger(backend="tensor").calibrate(
        ref.trigger.DetectorFeed(img=IMG, seed=9), 32)
    rep = design.trigger(backend=backend, window=window,
                         threshold=threshold).run(
        trigger.DetectorFeed(img=IMG, seed=9), 30)
    want = ref_design.trigger(backend=ref_backend, window=window,
                              threshold=threshold, pallas_kw=ref_kw).run(
        ref.trigger.DetectorFeed(img=IMG, seed=9), 30)
    got_s = np.array([d.score for d in rep.decisions])
    want_s = np.array([d.score for d in want.decisions])
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    clear = np.abs(want_s - threshold) > DECISION_BAND * max(1.0,
                                                             abs(threshold))
    assert clear.sum() >= 20
    got_a = np.array([d.accept for d in rep.decisions])
    want_a = np.array([d.accept for d in want.decisions])
    np.testing.assert_array_equal(got_a[clear], want_a[clear])
    assert 0 < want_a.sum() < 30                   # both sides exercised


def test_loop_partial_window_padding(design):
    loop = design.trigger(backend="tensor", window=8, threshold=0.0)
    rep = loop.run(trigger.DetectorFeed(img=IMG, seed=1), 10)
    assert rep.processed == 10                     # 8 + padded 2
    assert rep.windows == 2
    assert all(d.frame_id >= 0 for d in rep.decisions)


def test_loop_deadline_accounting(design):
    # an impossible deadline: every decision late, slack negative
    tight = trigger.TriggerBudget(max_latency_us=1e-3)
    rep = design.trigger(backend="tensor", window=4, budget=tight).run(
        trigger.DetectorFeed(img=IMG, seed=2), 12)
    assert rep.deadline_misses == rep.processed == 12
    assert rep.miss_pct == 100.0
    assert all(not d.deadline_met and d.slack_us < 0 for d in rep.decisions)
    assert "missed" in rep.summary()

    # a generous one: all met, slack positive
    loose = trigger.TriggerBudget(max_latency_us=60e6)
    rep2 = design.trigger(backend="tensor", window=4, budget=loose).run(
        trigger.DetectorFeed(img=IMG, seed=2), 12)
    assert rep2.deadline_misses == 0
    assert all(d.deadline_met and d.slack_us > 0 for d in rep2.decisions)


def test_loop_realtime_overrun_drops_oldest(design, one_thread):
    # a predicate 10x slower than the feed with a tiny ring: the loop
    # must lose (old) frames, never stall the producer
    slow = trigger.threshold_predicate(0.5)

    def slow_predicate(out):
        time.sleep(0.02)
        return slow(out)

    loop = design.trigger(backend="tensor", window=2, capacity=4,
                          predicate=slow_predicate)
    rep = loop.run(trigger.DetectorFeed(img=IMG, frame_rate_hz=2000,
                                        seed=3), 60, realtime=True)
    assert rep.realtime
    assert rep.dropped > 0
    assert rep.processed + rep.dropped == rep.frames == 60
    assert rep.drop_pct > 0
    # survivors decided in arrival order
    ids = [d.frame_id for d in rep.decisions]
    assert ids == sorted(ids)


@pytest.mark.parametrize("backend", ["tensor", "cuda"])
def test_loop_realtime_sustains_modest_rate(design, backend, one_thread):
    budget = trigger.TriggerBudget(max_latency_us=2e6)
    loop = design.trigger(backend=backend, window=4, budget=budget)
    rep = loop.run(trigger.DetectorFeed(img=IMG, frame_rate_hz=200,
                                        seed=4), 60, realtime=True)
    assert rep.dropped == 0
    assert rep.deadline_misses == 0
    assert rep.processed == 60
    assert rep.sustained_fps > 100                 # kept pace with the feed
    assert rep.p99_us >= rep.p50_us > 0


def test_loop_window_spans_and_counters(design):
    obs.enable()
    loop = design.trigger(backend="tensor", window=4,
                          budget=trigger.TriggerBudget(max_latency_us=1e-3))
    rep = loop.run(trigger.DetectorFeed(img=IMG, seed=6), 16)
    spans = [s for s in obs.tracer.spans() if s.name == "trigger.window"]
    assert len(spans) == rep.windows == 4
    assert all(s.attrs["frames"] == 4 for s in spans)
    assert {s.attrs["window"] for s in spans} == {0, 1, 2, 3}
    counters = obs.snapshot()["counters"]
    assert counters["trigger.windows"] == 4.0
    assert counters["trigger.deadline_misses"] == 16.0
    assert counters["trigger.accepts"] + counters["trigger.rejects"] == 16.0


def test_loop_rejects_bad_window(design):
    with pytest.raises(ValueError, match="window"):
        design.trigger(window=0)


def test_calibrate_refuses_custom_predicate(design):
    loop = design.trigger(backend="tensor",
                          predicate=trigger.threshold_predicate(0.1))
    with pytest.raises(ValueError, match="custom predicate"):
        loop.calibrate(trigger.DetectorFeed(img=IMG), 8)


def test_loop_defaults_to_the_designs_device_and_predicate_gets_numpy(
        design):
    seen = []

    def predicate(out):
        seen.append(type(out["dense_3_out"]))
        return trigger.threshold_predicate(0.1)(out)

    loop = design.trigger(backend="cuda", window=2, predicate=predicate)
    assert loop.device.type == "cpu"
    loop.run(trigger.DetectorFeed(img=IMG, seed=1), 4)
    assert seen == [np.ndarray, np.ndarray]


# -- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("window", [1, 16])
def test_trigger_on_card_decides_as_the_cpu_run(cuda, window):
    """The loop on the card (one captured graph per window shape) against
    the same loop with ``device="cpu"``: scores at the nest tier's
    kernel-vs-plain tolerance, decisions equal outside the band."""
    m = braggnn.build(1, 9)
    d = hls.Session(device=cuda).compile(m.bind(init_tree(
        m.specs(), torch.Generator().manual_seed(0))))
    feed = trigger.DetectorFeed(img=9, seed=11)
    card = d.trigger(backend="cuda", window=window)
    threshold = card.calibrate(feed, 64)
    rep = card.run(feed, 100)
    cpu = d.trigger(backend="cuda", window=window, device="cpu",
                    threshold=threshold).run(feed, 100)
    got = np.array([x.score for x in rep.decisions])
    want = np.array([x.score for x in cpu.decisions])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    clear = np.abs(want - threshold) > DECISION_BAND * max(1.0,
                                                           abs(threshold))
    np.testing.assert_array_equal(
        np.array([x.accept for x in rep.decisions])[clear],
        np.array([x.accept for x in cpu.decisions])[clear])
