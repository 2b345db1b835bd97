"""repro_torch.tune: spaces, strategies, evaluator gates, TuningDB
persistence, the CLI, the ``Design`` tuning verbs — the reference's
``tests/test_tune.py`` contracts run against the port's modules — and
parity with the reference: the same space hashes, the same proposals from
the same seed, and dry tunes that give the reference's trial sequence
field for field.

Search-loop mechanics are tested against fake trials (no compiles); the
end-to-end paths run on a small conv2d design and BraggNN(img=7) so the
file stays fast.  Designs compile on the CPU (``device="cpu"``); measure
mode there times the kernels' plain versions, and the ``gpu``-marked test
at the end times the DFG tier on the card.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.core import cachedir, frontend  # noqa: E402
from repro_torch.core.pipeline import (DEFAULT_PIPELINE,  # noqa: E402
                                       CompilerConfig, CompilerDriver)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.tune import (Bisection, Candidate, Evaluator,  # noqa: E402
                              HillClimb, Knob, RandomSearch, SearchSpace,
                              Trial, Tuner, TuningDB, best_config_for,
                              braggnn_space, conv2d_space, sweep_variants,
                              trigger_space)
from repro_torch.tune.cli import main as cli_main  # noqa: E402


def _conv_build(ctx):
    x = ctx.memref("input", (1, 2, 6, 6), "input")
    w = ctx.memref("weight", (3, 2, 3, 3), "weight")
    b = ctx.memref("bias", (3,), "weight")
    out = ctx.memref("out", (1, 3, 4, 4), "output")
    frontend.conv2d(ctx, x, w, b, out)


def _small_space():
    return SearchSpace((
        Knob("unroll_factor", (None, 8, 2)),
        Knob("pipelined_units", (False, True)),
    ), name="small")


def _fake_trial(candidate, latency, *, valid=True, dsp=0):
    return Trial(candidate=candidate, design_hash="x", latency_us=latency,
                 makespan=int(latency * 100), stage_ii=None, err=0.0,
                 valid=valid, resources={"DSP": dsp}, wire_bits=32,
                 est_roofline_us=0.0, measured_us=None, compile_s=0.0,
                 cached=False)


@pytest.fixture()
def session():
    return hls.Session(device="cpu")


# -- space -------------------------------------------------------------------


def test_space_default_size_and_lowering():
    space = conv2d_space()
    c = space.default()
    assert space.contains(c)
    assert space.size() == 2 * 3 * 2 * 2
    cfg = space.to_config(c)
    assert cfg.pipeline == DEFAULT_PIPELINE
    assert cfg.unroll_factor is None
    assert space.to_format(c) is None          # baseline fp32
    c2 = c.replace("precision", "5_4")
    assert space.to_format(c2).man_bits == 4
    assert space.to_config(c.replace("unroll_factor", 16)).unroll_factor == 16


def test_space_rejects_bad_knobs():
    with pytest.raises(ValueError, match="unknown knob"):
        SearchSpace((Knob("warp_speed", (1, 2)),))
    with pytest.raises(ValueError, match="unregistered pass"):
        SearchSpace((Knob("pipeline", (("cse", "not_a_pass"),)),))
    with pytest.raises(ValueError, match="precision"):
        SearchSpace((Knob("precision", ("fp64",)),))
    with pytest.raises(ValueError, match="empty domain"):
        Knob("unroll_factor", ())


def test_candidate_json_roundtrip_and_hash():
    c = Candidate.of({"pipeline": ("cse", "dce"), "unroll_factor": None,
                      "precision": "5_4"})
    back = Candidate.from_json(json.loads(json.dumps(c.to_json())))
    assert back == c
    assert hash(back) == hash(c)
    assert back.get("pipeline") == ("cse", "dce")


def test_space_hash_sensitive_to_domain_and_base():
    s1, s2 = _small_space(), _small_space()
    assert s1.space_hash() == s2.space_hash()
    s3 = SearchSpace(s1.knobs[:1], name="small")
    assert s3.space_hash() != s1.space_hash()
    s4 = SearchSpace(s1.knobs, name="small",
                     base=CompilerConfig(tree_threshold=2))
    assert s4.space_hash() != s1.space_hash()


# -- strategies (driven with fake trials, no compiles) -----------------------


def test_random_search_unique_in_space():
    space = _small_space()
    s = RandomSearch(seed=1)
    s.reset(space, space.default())
    seen = set()
    while (c := s.propose()) is not None:
        assert space.contains(c)
        assert c not in seen
        seen.add(c)
    assert len(seen) == space.size() - 1       # everything but the baseline


def test_hillclimb_descends_to_optimum():
    space = _small_space()

    def latency(c):
        base = {None: 3.0, 8: 2.0, 2: 1.0}[c.get("unroll_factor")]
        return base - (0.5 if c.get("pipelined_units") else 0.0)

    s = HillClimb()
    base = space.default()
    s.reset(space, base)
    s.observe(base, _fake_trial(base, latency(base)))
    evaluated = {base}
    while (c := s.propose()) is not None:
        if c in evaluated:
            continue
        evaluated.add(c)
        s.observe(c, _fake_trial(c, latency(c)))
    assert s.best.get("unroll_factor") == 2
    assert s.best.get("pipelined_units") is True


def test_bisection_finds_minimal_capacity_meeting_target():
    space = SearchSpace((Knob("unroll_factor", (None, 64, 16, 4, 1)),),
                        name="bs")
    lat = {1: 40.0, 4: 10.0, 16: 5.0, 64: 3.0, None: 1.0}
    s = Bisection(target_us=5.0)
    s.reset(space, space.default())
    n = 0
    while (c := s.propose()) is not None and n < 20:
        n += 1
        s.observe(c, _fake_trial(c, lat[c.get("unroll_factor")]))
    assert s.feasible.get("unroll_factor") == 16
    assert n <= 4                              # log2(5) bisection, not a scan


def test_bisection_precision_descent_stops_at_invalid():
    space = SearchSpace((
        Knob("unroll_factor", (None, 4)),
        Knob("precision", ("5_11", "5_4", "5_3")),
    ), name="bsp")
    s = Bisection(target_us=100.0)
    s.reset(space, space.default())
    while (c := s.propose()) is not None:
        valid = c.get("precision") != "5_3"    # (5,3) fails the gate
        s.observe(c, _fake_trial(c, 1.0, valid=valid))
    assert s.feasible.get("precision") == "5_4"


def test_sweep_variants_skips_and_orders():
    ran = []
    out = sweep_variants(
        [("a", 1), ("b", 2), ("c", 3)],
        lambda tag, p: ran.append(tag) or p * 10,
        skip=lambda tag, p: tag == "b")
    assert ran == ["a", "c"]
    assert out == {"a": 10, "c": 30}


# -- evaluator ---------------------------------------------------------------


@pytest.fixture(scope="module")
def conv_evaluator():
    return Evaluator(_conv_build, conv2d_space(), name="conv_eval")


def test_evaluator_validates_and_costs(conv_evaluator):
    ev = conv_evaluator
    t = ev.evaluate(ev.space.default())
    assert t.valid and t.err <= 1e-3
    assert t.latency_us > 0 and t.makespan > 0
    assert t.est_roofline_us > 0
    assert t.measured_us is None               # dry by default
    assert ev.device is None and ev.settings()["device"] is None
    assert t.resources["DSP"] > 0

    tq = ev.evaluate(ev.space.default().replace("precision", "5_4"))
    assert tq.err > t.err
    assert tq.wire_bits == 12 < t.wire_bits

    evals = ev.n_evals
    tu = ev.evaluate(ev.space.default().replace("unroll_factor", 4))
    assert ev.n_evals == evals + 1
    assert tu.makespan > t.makespan
    assert tu.err == t.err                     # same optimised graph


def test_evaluator_invalid_when_tolerance_zero():
    ev = Evaluator(_conv_build, conv2d_space(), tol_abs=0.0, tol_rel=0.0)
    t = ev.evaluate(ev.space.default().replace("precision", "5_4"))
    assert not t.valid
    assert t.score() is None


def test_measure_mode_times_the_dfg_tier(monkeypatch):
    """Measure mode runs the design's default ``cuda`` runner — the DFG
    tier, whose segment the plain version renders on the CPU — memoised on
    the pass key, and the run context names the device."""
    from repro_torch.kernels.dfg_segment import ops as seg_ops
    calls = []
    real = seg_ops.segment

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(seg_ops, "segment", counting)
    ev = Evaluator(_conv_build, conv2d_space(), measure=True, device="cpu",
                   measure_reps=3)
    assert ev.settings()["mode"] == "measure"
    assert ev.settings()["device"] == "cpu"
    t = ev.evaluate(ev.space.default())
    assert t.measured_us is not None and t.measured_us > 0
    assert len(calls) == 1 + 3                 # the warm-up and each rep
    tu = ev.evaluate(ev.space.default().replace("unroll_factor", 4))
    assert tu.measured_us == t.measured_us     # same pass key: memoised
    assert len(calls) == 4
    assert "measured=" in t.summary()
    back = Trial.from_json(json.loads(json.dumps(t.to_json())))
    assert back.measured_us == t.measured_us


def test_roofline_reads_the_h100_constants(conv_evaluator):
    from repro_torch.tune.evaluator import _FLOPS_TABLE, roofline_estimate_us
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (67e12, 3.35e12)
    d = conv_evaluator.compile_candidate(conv_evaluator.space.default())
    g = d.graph_opt
    flops = int(_FLOPS_TABLE[g.cols().opcode].sum())
    want = max(flops / 67e12, 4.0 * g.n_values / 3.35e12) * 1e6
    assert roofline_estimate_us(d) == want


# -- tuner + db --------------------------------------------------------------


def test_tuner_end_to_end_persists_and_serves_reruns(tmp_path):
    db = TuningDB(tmp_path / "db.json")
    space = conv2d_space()
    driver = CompilerDriver()
    ev = Evaluator(_conv_build, space, driver=driver, name="conv_tune")
    res = Tuner(ev, HillClimb(), db=db, budget=5).run()

    assert not res.from_db
    assert len(res.trials) <= 5
    assert res.best.valid
    assert res.best.latency_us <= res.baseline.latency_us
    assert db.path.exists()

    entries = db.entries_for(res.design_fingerprint, res.space_hash)
    assert len(entries) == 1
    entry = next(iter(entries.values()))
    assert entry["strategy"] == "hillclimb"
    assert entry["context"]["eval"]["mode"] == "dry"
    assert entry["n_trials"] == len(res.trials)

    ev2 = Evaluator(_conv_build, space, driver=driver, name="conv_tune")
    res2 = Tuner(ev2, HillClimb(), db=db, budget=5).run()
    assert res2.from_db
    assert ev2.n_evals == 0
    assert res2.best.candidate == res.best.candidate

    res3 = Tuner(ev2, HillClimb(), db=db, budget=7).run()
    assert not res3.from_db

    ev3 = Evaluator(_conv_build, space, driver=driver, name="conv_tune",
                    scale=0.2)
    res4 = Tuner(ev3, HillClimb(), db=db, budget=5).run()
    assert not res4.from_db
    assert len(db.entries_for(res.design_fingerprint, res.space_hash)) == 2

    hit = best_config_for(ev.graph, space, db=db)
    assert hit is not None
    cfg, cand = hit
    assert cand in {res3.best.candidate, res4.best.candidate}
    assert cfg == space.to_config(cand)


def test_db_invalid_best_never_served(tmp_path):
    from repro_torch.tune.db import best_entry

    db = TuningDB(tmp_path / "db.json")
    space = conv2d_space()
    ev = Evaluator(_conv_build, space, tol_abs=0.0, tol_rel=0.0)
    res = Tuner(ev, Bisection(target_us=1e9), db=db, budget=2).run()
    assert not res.best.valid
    assert "numerics gate" in res.summary()
    assert best_entry(db, res.design_fingerprint, res.space_hash) is None
    assert best_config_for(ev.graph, space, db=db) is None

    ev2 = Evaluator(_conv_build, space, tol_abs=0.0, tol_rel=0.0)
    res2 = Tuner(ev2, Bisection(target_us=1.0), db=db, budget=2).run()
    assert not res2.from_db

    ev3 = Evaluator(_conv_build, space)
    Tuner(ev3, HillClimb(), db=db, budget=3).run()
    assert best_config_for(ev3.graph, space, db=db) is not None
    assert len(db.entries_for(res.design_fingerprint, res.space_hash)) == 3


def test_measured_entries_win_the_lookup(tmp_path):
    """A measure-mode entry beats a dry one for the same design, whatever
    their latencies (the reference's preference, kept)."""
    from repro_torch.tune.db import best_entry
    db = TuningDB(tmp_path / "db.json")
    space = conv2d_space()
    dry = Tuner(Evaluator(_conv_build, space), RandomSearch(seed=0), db=db,
                budget=3).run()
    meas = Tuner(Evaluator(_conv_build, space, measure=True, device="cpu",
                           measure_reps=1),
                 Bisection(target_us=1e9), db=db, budget=2).run()
    win = best_entry(db, dry.design_fingerprint, dry.space_hash)
    assert win["context"]["eval"]["mode"] == "measure"
    assert win["context"]["eval"]["device"] == "cpu"
    assert Candidate.from_json(win["best"]["candidate"]) == \
        meas.best.candidate


def test_tuner_force_researches(tmp_path):
    db = TuningDB(tmp_path / "db.json")
    ev = Evaluator(_conv_build, conv2d_space())
    Tuner(ev, RandomSearch(seed=0), db=db, budget=2).run()
    before = ev.n_evals
    res = Tuner(ev, RandomSearch(seed=0), db=db, budget=2).run(force=True)
    assert not res.from_db
    assert ev.n_evals > before


# -- the port's own versioned cache root -------------------------------------


def test_cache_root_evicts_stale_versions(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    stale = tmp_path / "v1" / "designs"
    stale.mkdir(parents=True)
    (stale / "old.pkl").write_bytes(b"stale")
    unrelated = tmp_path / "not_a_version"
    unrelated.mkdir()

    root = cachedir.cache_root("tune")
    assert root == tmp_path / f"v{cachedir.CACHE_FORMAT_VERSION}" / "tune"
    assert root.is_dir()
    assert not (tmp_path / "v1").exists()
    assert unrelated.exists()

    db = TuningDB()
    assert db.path.parent == root
    db.put("fp", "sh", {"best": {"candidate": {"unroll_factor": 4}}})
    assert db.get("fp", "sh")["best"]["candidate"] == {"unroll_factor": 4}


def test_reference_tuning_db_is_never_read(tmp_path, monkeypatch):
    """The port's default DB lives under its own root
    (``repro_torch_cache_<uid>``), never the reference's, whatever the
    reference's environment variable says."""
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    path = TuningDB().path
    assert path.is_relative_to(tmp_path)
    assert "repro_torch_cache_" in str(path)
    assert not path.is_relative_to(tmp_path / "reference")


def test_tuning_db_discards_stale_schema(tmp_path):
    path = tmp_path / "db.json"
    path.write_text(json.dumps({"version": -1, "entries": {"k": {}}}))
    db = TuningDB(path)
    assert db.entries() == {}
    db.put("a", "b", {"best": {}})
    assert json.loads(path.read_text())["version"] == \
        cachedir.CACHE_FORMAT_VERSION


# -- CLI ---------------------------------------------------------------------


def test_cli_conv2d_dry_and_db_rerun(tmp_path, capsys):
    db_path = str(tmp_path / "cli_db.json")
    argv = ["--config", "conv2d", "--dry", "--budget", "3", "--db", db_path,
            "--device", "cpu"]
    res = cli_main(argv)
    assert not res.from_db
    assert res.best.latency_us <= res.baseline.latency_us
    out = capsys.readouterr().out
    assert "trial   1" in out and "best of" in out
    assert "roofline estimate (H100)" in out

    res2 = cli_main(argv)
    assert res2.from_db
    assert "served from tuning DB" in capsys.readouterr().out

    res3 = cli_main(["--config", "conv2d", "--dry", "--db", db_path,
                     "--show"])
    assert res3.from_db
    assert res3.best.candidate == res2.best.candidate


def test_cli_measure_mode_on_cpu(tmp_path, capsys):
    res = cli_main(["--config", "conv2d", "--budget", "2", "--db",
                    str(tmp_path / "m.json"), "--device", "cpu"])
    assert all(t.measured_us > 0 for t in res.trials)
    assert "measured DFG-tier latency on cpu" in capsys.readouterr().out


def test_precision_only_candidates_share_one_design_and_pass_stage(session):
    space = conv2d_space()
    base = space.default()
    for prec in ("5_11", "5_4", "5_3"):
        session.compile(_conv_build, name="conv_prec",
                        config=space.to_config(base.replace("precision",
                                                            prec)))
    st = session.stats()
    assert st["recompiles"] == 1
    assert st["hits"] == 2
    assert st["pass_memo_hits"] == 0

    session.compile(_conv_build, name="conv_unroll",
                    config=space.to_config(base.replace("unroll_factor",
                                                        4)))
    st2 = session.stats()
    assert st2["recompiles"] == 2
    assert st2["pass_memo_hits"] == 1
    assert st2["pass_memo_entries"] == 1


# -- trigger-budget gate -----------------------------------------------------


def test_budget_gate_flips_winner():
    from repro_torch.trigger import TriggerBudget

    space = conv2d_space()
    driver = CompilerDriver()
    ev = Evaluator(_conv_build, space, driver=driver, name="conv_gate")
    free = Tuner(ev, RandomSearch(seed=0), budget=24).run()
    free_dsp = free.best.resources["DSP"]
    assert free.best.feasible and free.best.budget_failures == []

    budget = TriggerBudget(max_dsp=free_dsp - 1)
    ev2 = Evaluator(_conv_build, space, driver=driver, name="conv_gate",
                    budget=budget)
    capped = Tuner(ev2, RandomSearch(seed=0), budget=24).run()
    assert capped.best.candidate != free.best.candidate
    assert capped.best.feasible
    assert capped.best.resources["DSP"] < free_dsp
    assert capped.best.latency_us >= free.best.latency_us

    over = [t for t in capped.trials if not t.feasible]
    assert over
    assert all(t.score() is None for t in over)
    assert all("DSP" in t.budget_failures for t in over)
    assert any("OVER BUDGET" in t.summary() for t in over)

    assert ev.settings()["budget"] is None
    assert ev2.settings()["budget"] == budget.key()


def test_design_tune_accepts_trigger_budget(session, tmp_path):
    from repro_torch.trigger import TriggerBudget, part

    design = session.compile(_conv_build, name="conv_design_tune")
    space = conv2d_space()

    free = design.tune(space, strategy=RandomSearch(seed=0), trials=24,
                       db=TuningDB(tmp_path / "free.json"))
    cap = free.best.resources["DSP"] - 1
    capped = design.tune(space, strategy=RandomSearch(seed=0),
                         budget=TriggerBudget(max_dsp=cap), trials=24,
                         db=TuningDB(tmp_path / "capped.json"))
    assert capped.best.candidate != free.best.candidate
    assert capped.best.resources["DSP"] <= cap

    capped2 = design.tune(space, strategy=RandomSearch(seed=0), trials=24,
                          part=part(dsp=cap),
                          db=TuningDB(tmp_path / "capped2.json"))
    assert capped2.best.candidate == capped.best.candidate

    with pytest.raises(ValueError, match="not both"):
        design.tune(space, budget=TriggerBudget(max_dsp=4),
                    trigger_budget=TriggerBudget(max_dsp=4))


def test_db_infeasible_best_never_served(tmp_path):
    from repro_torch.trigger import TriggerBudget
    from repro_torch.tune.db import best_entry

    db = TuningDB(tmp_path / "db.json")
    space = conv2d_space()
    ev = Evaluator(_conv_build, space, budget=TriggerBudget(max_dsp=1))
    res = Tuner(ev, RandomSearch(seed=0), db=db, budget=4).run()
    assert not res.best.feasible
    assert "trigger budget" in res.summary()
    assert "DSP" in res.summary()
    assert best_entry(db, res.design_fingerprint, res.space_hash) is None
    assert best_config_for(ev.graph, space, db=db) is None

    ev2 = Evaluator(_conv_build, space, budget=TriggerBudget(max_dsp=10 ** 6))
    res2 = Tuner(ev2, RandomSearch(seed=0), db=db, budget=4).run()
    assert res2.best.feasible
    hit = best_config_for(ev2.graph, space, db=db)
    assert hit is not None and hit[1] == res2.best.candidate

    back = Trial.from_json(json.loads(json.dumps(res.best.to_json())))
    assert back.feasible is False
    assert back.budget_failures == res.best.budget_failures


# -- the Design verbs ---------------------------------------------------------


def test_tune_persists_and_apply_tuned_loads(session, tmp_path, caplog):
    import logging
    db = TuningDB(tmp_path / "db.json")
    space = conv2d_space()
    design = session.compile(_conv_build, name="conv_api")

    with caplog.at_level(logging.WARNING, logger="repro_torch"):
        same, cand = design.apply_tuned(space, db=db)
    assert same is design and cand is None
    assert str(db.path) in caplog.text
    caplog.clear()

    result = design.tune(space, strategy="random", budget=2, db=db, dry=True)
    assert len(result.trials) >= 1 and len(db) == 1

    tuned, cand = design.apply_tuned(space, db=db)
    assert cand is not None
    assert tuned.config == space.to_config(cand)
    assert tuned.tuned_candidate is cand
    assert tuned.precision == (None if cand.get("precision") == "fp32"
                               else cand.get("precision"))
    assert f"tuned    : {cand.label()}" in tuned.report()
    assert design.precision is None and design.tuned_candidate is None
    again = design.tune(space, strategy="random", budget=2, db=db, dry=True)
    assert again.from_db

    d3 = hls.compile(_conv_build, session=session, tuned=space, db=db)
    assert d3.tuned_candidate is not None
    assert d3.config == space.to_config(d3.tuned_candidate)
    empty = TuningDB(tmp_path / "empty.json")
    with caplog.at_level(logging.WARNING, logger="repro_torch"):
        d4 = hls.compile(_conv_build, session=session, tuned=space,
                         db=empty)
    assert d4.tuned_candidate is None
    assert str(empty.path) in caplog.text


def test_tuned_design_serves_at_its_precision(session, tmp_path):
    """``apply_tuned`` -> ``serve(backend="cuda", fmt=design.precision)``
    through the DFG tier equals ``Design.run`` at that precision."""
    from repro_torch.core.precision import FORMATS
    space = SearchSpace((Knob("unroll_factor", (None, 4)),
                         Knob("precision", ("5_4",))), name="prec")
    design = session.compile(_conv_build, name="conv_prec_serve")
    db = TuningDB(tmp_path / "db.json")
    design.tune(space, strategy="bisect", budget=3, db=db)
    tuned, cand = design.apply_tuned(space, db=db)
    assert tuned.precision == "5_4"
    rng = np.random.default_rng(0)
    feeds = {"input": rng.normal(0, 0.4, (3, 1, 2, 6, 6)),
             "weight": rng.normal(0, 0.4, (3, 2, 3, 3)),
             "bias": rng.normal(0, 0.4, (3,))}
    feeds = {k: v.astype(np.float32) for k, v in feeds.items()}
    rep = tuned.serve([feeds], backend="cuda", fmt=tuned.precision,
                      cuda_kw={"mode": "dfg"}, device="cpu", collect=True)
    got = rep.outputs[0]["out"].numpy()
    np.testing.assert_array_equal(
        got, tuned.run(feeds, fmt=FORMATS[tuned.precision])["out"])


# ---------------------------------------------------------------------------
# Parity with the reference package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The reference package (it imports JAX)."""
    pytest.importorskip("jax")
    import repro.tune
    import repro.tune.cli
    from repro.core.pipeline import CompilerDriver as RefDriver
    from repro.launch import roofline as ref_roofline
    return types.SimpleNamespace(tune=repro.tune, cli=repro.tune.cli,
                                 Driver=RefDriver, roofline=ref_roofline)


@pytest.mark.parametrize("name", ["braggnn_space", "conv2d_space",
                                  "trigger_space"])
def test_space_hash_and_candidates_equal_reference(ref, name):
    mine, theirs = globals()[name](), getattr(ref.tune, name)()
    assert mine.space_hash() == theirs.space_hash()
    assert mine.describe() == theirs.describe()
    assert [c.to_json() for c in mine.enumerate()] == \
        [c.to_json() for c in theirs.enumerate()]


@pytest.mark.parametrize("seed", [0, 7])
def test_random_search_proposes_as_reference(ref, seed):
    mine, theirs = braggnn_space(), ref.tune.braggnn_space()
    a, b = RandomSearch(seed=seed), ref.tune.RandomSearch(seed=seed)
    a.reset(mine, mine.default())
    b.reset(theirs, theirs.default())
    for _ in range(25):
        assert a.propose().to_json() == b.propose().to_json()


#: the fields of a trial that must equal the reference's in a dry tune
TRIAL_FIELDS = ("design_hash", "latency_us", "makespan", "stage_ii", "err",
                "valid", "feasible", "resources", "wire_bits")


def _strategy(pkg, name):
    return {"hillclimb": pkg.HillClimb, "bisect": pkg.Bisection,
            "random": lambda: pkg.RandomSearch(seed=3)}[name]()


@pytest.mark.parametrize("config,budget", [("conv2d", 4),
                                           ("braggnn-tiny", 3)])
@pytest.mark.parametrize("strategy", ["hillclimb", "bisect", "random"])
def test_dry_tune_gives_the_reference_trials(ref, config, budget, strategy):
    """The same trial sequence field for field (``err`` bitwise);
    ``est_roofline_us`` differs by the machine constants only: the port's
    reads the H100's, the reference's the v5e's, over the same FLOP and
    byte counts."""
    from repro_torch.tune.cli import _configs
    from repro_torch.tune.evaluator import _FLOPS_TABLE
    build, space, kw = _configs()[config]
    rbuild, rspace, rkw = ref.cli._configs()[config]
    assert kw == rkw
    runs = []
    for pkg, b, sp, drv in ((ref.tune, rbuild, rspace, ref.Driver()),
                            (None, build, space, CompilerDriver())):
        if pkg is None:
            ev = Evaluator(b, sp, driver=drv, **kw)
            tuner = Tuner(ev, _strategy(_port_tune(), strategy),
                          budget=budget)
        else:
            ev = pkg.Evaluator(b, sp, driver=drv, **kw)
            tuner = pkg.Tuner(ev, _strategy(pkg, strategy), budget=budget)
        runs.append((tuner.run(), ev))
    (theirs, rev), (mine, ev) = runs
    assert [t.candidate.to_json() for t in mine.trials] == \
        [t.candidate.to_json() for t in theirs.trials]
    for a, b in zip(mine.trials, theirs.trials):
        for f in TRIAL_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.measured_us is None and b.measured_cpu_us is None
        g = ev.compile_candidate(a.candidate).graph_opt
        flops = int(_FLOPS_TABLE[g.cols().opcode].sum())
        nbytes = 4.0 * g.n_values
        assert a.est_roofline_us == max(
            flops / roofline.PEAK_FLOPS, nbytes / roofline.HBM_BW) * 1e6
        assert b.est_roofline_us == max(
            flops / ref.roofline.PEAK_FLOPS,
            nbytes / ref.roofline.HBM_BW) * 1e6
    assert mine.best.candidate.to_json() == theirs.best.candidate.to_json()


def _port_tune():
    import repro_torch.tune
    return repro_torch.tune


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_measure_mode_times_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import registry
    ev = Evaluator(_conv_build, conv2d_space(), measure=True, measure_reps=5)
    assert ev.device.type == "cuda"
    assert ev.settings()["device"] == torch.cuda.get_device_name(0)
    registry.reset_launch_counts()
    t = ev.evaluate(ev.space.default())
    # the eager run before the capture and five replays, each one K4
    # launch (the capture itself launches nothing)
    assert registry.launch_counts()["dfg_segment"] == 1 + 5
    assert t.measured_us is not None and 0 < t.measured_us < 1e5
