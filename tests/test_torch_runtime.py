"""The port's training runtime: the data pipeline, checkpoints, the
fault-tolerant training driver and the two examples, on the CPU.

The pipeline's batches equal the reference's bit for bit (the same numpy
code); a checkpoint the reference wrote restores into the port leaf for
leaf, and the other way round; the driver's contracts mirror
``tests/test_fault_tolerance.py``, driven by a BraggNN train step and a
seekable stream of synthetic peaks.
"""

import json
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.hls as hls  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.examples import braggnn_serve, quickstart  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402
from repro_torch.nn.module import (init_tree, map_tree,  # noqa: E402
                                   tree_leaves)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import (DriverConfig, FailureInjector,  # noqa: E402
                                 TrainingDriver)

IMG = 11


@pytest.fixture(scope="module")
def ref():
    """The reference package's runtime modules (they import JAX)."""
    jax = pytest.importorskip("jax")
    import types

    import jax.numpy as jnp
    from repro.checkpoint.ckpt import CheckpointManager as RefCkpt
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
    return types.SimpleNamespace(jax=jax, jnp=jnp, CheckpointManager=RefCkpt,
                                 DataConfig=RefDataConfig,
                                 SyntheticTokenPipeline=RefPipeline)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

CONFIGS = [dict(seq_len=32, global_batch=4, vocab_size=1000, seed=7),
           dict(seq_len=16, global_batch=2, vocab_size=100),
           dict(seq_len=8, global_batch=4, vocab_size=50, num_hosts=2,
                host_id=0),
           dict(seq_len=8, global_batch=4, vocab_size=50, num_hosts=2,
                host_id=1),
           dict(seq_len=64, global_batch=4, vocab_size=97)]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_batch_at_bitwise_equals_reference(ref, cfg):
    port = SyntheticTokenPipeline(DataConfig(**cfg))
    want = ref.SyntheticTokenPipeline(ref.DataConfig(**cfg))
    assert port.local_batch == want.local_batch
    for step in (0, 1, 5, 1000):
        a, b = port.batch_at(step), want.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_order_and_seek_equal_reference(ref):
    cfg = dict(seq_len=8, global_batch=2, vocab_size=64, prefetch=2)
    port = SyntheticTokenPipeline(DataConfig(**cfg))
    want = ref.SyntheticTokenPipeline(ref.DataConfig(**cfg))
    try:
        port.seek(0)
        for step in range(4):
            np.testing.assert_array_equal(port.get(step)["tokens"],
                                          want.batch_at(step)["tokens"])
        port.seek(1)                          # rewind: the restart path
        for step in (1, 2):
            np.testing.assert_array_equal(port.get(step)["tokens"],
                                          want.batch_at(step)["tokens"])
        np.testing.assert_array_equal(port.get(0)["targets"],
                                      want.batch_at(0)["targets"])
    finally:
        port.stop()
    assert port._thread is None


def test_host_sharding_disjoint():
    h0, h1 = (SyntheticTokenPipeline(DataConfig(
        seq_len=8, global_batch=4, vocab_size=50, num_hosts=2, host_id=i))
        for i in (0, 1))
    assert h0.local_batch == h1.local_batch == 2
    assert not np.array_equal(h0.batch_at(3)["tokens"],
                              h1.batch_at(3)["tokens"])
    with pytest.raises(ValueError, match="split"):
        SyntheticTokenPipeline(DataConfig(seq_len=8, global_batch=3,
                                          vocab_size=50, num_hosts=2))


def test_straggler_substitution():
    pipe = SyntheticTokenPipeline(DataConfig(
        seq_len=8, global_batch=2, vocab_size=64, prefetch=1,
        deadline_s=0.05))
    pipe.fetch_delay_s = 0.5          # inject slow I/O
    pipe.seek(0)
    try:
        batch = pipe.get(0)           # must not block past the deadline
    finally:
        pipe.stop()
    assert batch["tokens"].shape == (2, 8)
    assert pipe.straggler_substitutions >= 1
    # the substituted batch is the deterministic one
    np.testing.assert_array_equal(batch["tokens"], pipe.batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3))},
            "step": torch.tensor(5, dtype=torch.int32),
            "seq": [torch.full((2,), 7.0), torch.zeros(1)]}


def test_checkpoint_atomicity_and_retention(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [3, 4]                        # retention
    assert not list(pathlib.Path(tmp_path).glob(".tmp_*"))   # atomicity
    restored, step = ckpt.restore(tree)
    assert step == 4
    for got, want in zip(tree_leaves(restored), tree_leaves(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert isinstance(restored["seq"], list)
    # an interrupted save (a leftover temporary directory) is not a step
    (pathlib.Path(tmp_path) / ".tmp_step_000000009").mkdir()
    assert ckpt.latest_step() == 4


def test_async_checkpoint_snapshots_before_writing(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones((64, 64))}
    gate = threading.Event()
    ckpt._pool.submit(gate.wait, 10)     # hold the writer thread
    ckpt.save_async(10, tree)
    tree["w"].add_(1.0)                  # the step loop moves on in place
    gate.set()
    ckpt.wait()
    assert ckpt.latest_step() == 10
    restored, _ = ckpt.restore(tree)
    assert torch.equal(restored["w"], torch.ones((64, 64)))


def test_structure_mismatch_rejected(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"a": torch.ones((4,))})
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore({"a": torch.ones((4,)), "b": torch.ones((2,))})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"a": torch.ones((5,))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"a": 1})


def test_restores_a_reference_checkpoint_leaf_for_leaf(ref, tmp_path):
    jnp = ref.jnp
    tree = {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                       "b": jnp.full((4,), -2.5)},
            "opt": {"step": jnp.asarray(3, jnp.int32),
                    "mu": [jnp.ones((2, 2)), jnp.zeros((5,))]}}
    ref.CheckpointManager(str(tmp_path), keep=2).save(7, tree)
    like = ref.jax.tree_util.tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32
                              if x.dtype == jnp.float32 else torch.int32),
        tree)
    got, step = CheckpointManager(str(tmp_path)).restore(like, device="cpu")
    assert step == 7
    want = ref.jax.tree_util.tree_leaves(tree)
    assert len(tree_leaves(got)) == len(want) == 5
    for g, w in zip(tree_leaves(got), want):
        assert str(g.numpy().dtype) == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_writes_the_reference_layout(ref, tmp_path):
    """The same tree saved by both packages: the same manifest, and the
    reference restores the port's checkpoint."""
    jnp = ref.jnp
    j_tree = {"b": {"c": jnp.ones((3, 3))}, "a": jnp.arange(8.0),
              "l": [jnp.zeros((2,)), jnp.asarray(4, jnp.int32)]}
    t_tree = ref.jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), j_tree)
    ref.CheckpointManager(str(tmp_path / "ref")).save(3, j_tree)
    CheckpointManager(str(tmp_path / "port")).save(3, t_tree)
    m_ref, m_port = (json.loads((tmp_path / k / "step_000000003" /
                                 "manifest.json").read_text())
                     for k in ("ref", "port"))
    assert m_port == m_ref
    back, step = ref.CheckpointManager(str(tmp_path / "port")).restore(j_tree)
    assert step == 3
    for b, w in zip(ref.jax.tree_util.tree_leaves(back),
                    ref.jax.tree_util.tree_leaves(j_tree)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(w))


# ---------------------------------------------------------------------------
# the training driver, on a BraggNN train step
# ---------------------------------------------------------------------------

class PeaksPipeline:
    """A seekable synthetic-peaks stream: batch ``step`` is drawn from a
    generator seeded by (seed, step)."""

    def __init__(self, batch: int = 8, seed: int = 5):
        self.batch, self.seed = batch, seed
        self.seeks: list[int] = []

    def seek(self, step: int) -> None:
        self.seeks.append(step)

    def get(self, step: int) -> dict:
        gen = torch.Generator().manual_seed(self.seed * 100_003 + step)
        x, y = braggnn.synthetic_peaks(self.batch, IMG, gen)
        return {"x": x, "y": y}

    def stop(self) -> None:
        pass


def _setup(tmp_path, total_steps=12, fail_at=(), max_restarts=3):
    params = init_tree(braggnn.specs(1, IMG), torch.Generator().manual_seed(0))
    step = braggnn.make_step(adamw.AdamWConfig(
        peak_lr=3e-2, warmup_steps=20, total_steps=2000, weight_decay=0.0))

    def train_step(p, o, batch):
        p, o, loss = step(p, o, batch["x"], batch["y"])
        return p, o, {"loss": loss}

    driver = TrainingDriver(
        DriverConfig(total_steps=total_steps, checkpoint_every=4,
                     max_restarts=max_restarts),
        train_step=train_step, pipeline=PeaksPipeline(),
        ckpt=CheckpointManager(str(tmp_path), keep=3),
        injector=FailureInjector(fail_at))
    return driver, params, adamw.init_state(params)


def test_restart_is_bit_exact(tmp_path):
    d1, p1, o1 = _setup(tmp_path / "a")
    rep1 = d1.run(p1, o1)
    d2, p2, o2 = _setup(tmp_path / "b", fail_at=(7,))
    rep2 = d2.run(p2, o2)
    assert rep1.restarts == 0 and rep2.restarts == 1
    assert d2.injector.fired == [7]
    assert d2.pipeline.seeks == [0, 4]         # resumed at the checkpoint
    # steps 0..6, then 4..11 again from the step-4 checkpoint: the same
    # losses, bit for bit
    assert rep2.losses == rep1.losses[:7] + rep1.losses[4:]
    assert rep1.steps_run == rep2.steps_run == 12
    assert set(rep1.final_metrics) == {"loss"}
    s1 = CheckpointManager(str(tmp_path / "a")).latest_step()
    s2 = CheckpointManager(str(tmp_path / "b")).latest_step()
    assert s1 == s2 == 12
    like = {"params": p1, "opt": o1}
    f1, _ = CheckpointManager(str(tmp_path / "a")).restore(like)
    f2, _ = CheckpointManager(str(tmp_path / "b")).restore(like)
    for a, b in zip(tree_leaves(f1), tree_leaves(f2)):
        assert torch.equal(a, b)


def test_too_many_failures_raise(tmp_path):
    d, p, o = _setup(tmp_path, fail_at=(2,), max_restarts=0)
    with pytest.raises(RuntimeError, match="injected failure"):
        d.run(p, o)


def test_failure_before_any_checkpoint_restarts_from_scratch(tmp_path):
    d1, p1, o1 = _setup(tmp_path / "a", total_steps=6)
    d2, p2, o2 = _setup(tmp_path / "b", total_steps=6, fail_at=(2,))
    rep1, rep2 = d1.run(p1, o1), d2.run(p2, o2)
    assert d2.pipeline.seeks == [0, 0]
    assert rep2.losses == rep1.losses[:2] + rep1.losses


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_the_cpu():
    quickstart.main(["--device", "cpu"])


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        braggnn_serve.train(braggnn.build(1, IMG), steps=1)


def test_braggnn_serve_train_binds_and_compiles():
    model = braggnn.build(s=1)
    tree = braggnn_serve.train(model, steps=3, device="cpu")
    want = init_tree(model.specs(), torch.Generator().manual_seed(0))
    assert [t.shape for t in tree_leaves(tree)] == \
        [t.shape for t in tree_leaves(want)]
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(tree), tree_leaves(want)))
    bound = model.bind(map_tree(lambda t: t.detach().cpu(), tree))
    design = hls.compile(bound, device="cpu")
    x, _ = braggnn.synthetic_peaks(4, IMG, torch.Generator().manual_seed(3))
    got = design.serve([x], backend="tensor", fmt="5_4", collect=True)
    assert got.outputs[0].shape == (4, 2)
    assert bool(torch.isfinite(got.outputs[0]).all())
