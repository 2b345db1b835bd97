"""The port's compile path against the reference's, and its import rule.

The compiler core of ``repro_torch`` is the reference's numpy code carried
over with its imports renamed, so the held contract is identity: the same
``graph_fingerprint`` and ``design_hash`` for the same program, and a
numpy ``evaluate`` equal bit for bit.  The port imports neither ``jax``
nor anything of ``repro`` at runtime.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.hls as ref_hls  # noqa: E402
import repro_torch.hls as hls  # noqa: E402
from repro.core import frontend as ref_frontend  # noqa: E402
from repro.core import verify as ref_verify  # noqa: E402
from repro.core.precision import FORMATS as REF_FORMATS  # noqa: E402
from repro.models import braggnn as ref_braggnn  # noqa: E402
from repro_torch.core import cachedir, emit, frontend, pipeline  # noqa: E402
from repro_torch.core import verify  # noqa: E402
from repro_torch.core.precision import FORMATS  # noqa: E402
from repro_torch.models import braggnn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _conv_build(fe):
    def build(ctx):
        x = ctx.memref("input", (1, 3, 8, 8), "input")
        w = ctx.memref("weight", (4, 3, 3, 3), "weight")
        b = ctx.memref("bias", (4,), "weight")
        out = ctx.memref("out", (1, 4, 6, 6), "output")
        fe.conv2d(ctx, x, w, b, out)
    build.__name__ = "conv_port_parity"
    return build


@pytest.fixture(scope="module")
def conv_pair():
    return (ref_hls.Session().compile(_conv_build(ref_frontend)),
            hls.Session(device="cpu").compile(_conv_build(frontend)))


@pytest.fixture(scope="module")
def bragg_params():
    m = ref_braggnn.build(1, 9)
    return jax.tree_util.tree_map(np.asarray,
                                  m.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def bragg_pair(bragg_params):
    ref = ref_hls.Session().compile(
        ref_braggnn.build(1, 9).bind(bragg_params))
    port = hls.Session(device="cpu").compile(braggnn.build(
        1, 9, params=braggnn.params_from_numpy(bragg_params)))
    return ref, port


# ---------------------------------------------------------------------------
# Identity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", ["conv_pair", "bragg_pair"])
def test_fingerprint_and_design_hash_equal_reference(pair, request):
    ref, port = request.getfixturevalue(pair)
    assert port.fingerprint == ref.fingerprint
    assert port.design_hash == ref.design_hash
    assert port.makespan == ref.makespan
    assert len(port.graph_opt.ops) == len(ref.graph_opt.ops)


def test_conv_evaluate_bitwise_equals_reference(conv_pair):
    ref, port = conv_pair
    feeds = verify.random_feeds(port.graph_raw, batch=3, seed=0)
    ref_feeds = ref_verify.random_feeds(ref.graph_raw, batch=3, seed=0)
    for k in feeds:
        np.testing.assert_array_equal(feeds[k], ref_feeds[k])
    for raw in (False, True):
        want = ref.run(feeds, raw=raw)
        got = port.run(feeds, raw=raw)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fmt", [None, "5_11", "5_4", "5_3"])
def test_braggnn_evaluate_bitwise_equals_reference(bragg_pair, fmt):
    ref, port = bragg_pair
    x = np.random.default_rng(1).standard_normal(
        (3, 1, 1, 9, 9)).astype(np.float32)
    want = ref.run(x, fmt=REF_FORMATS[fmt] if fmt else None)
    got = port.run(x, fmt=FORMATS[fmt] if fmt else None)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_handwritten_braggnn_fingerprint_equals_bridged():
    g_hand = hls.trace(lambda ctx: frontend.braggnn(ctx, s=1, img=7))
    assert pipeline.graph_fingerprint(g_hand) == pipeline.graph_fingerprint(
        hls.trace(braggnn.build(1, 7)))


def test_python_scheduler_matches_c_core(monkeypatch, conv_pair):
    _, port = conv_pair
    monkeypatch.setenv("REPRO_TORCH_SCHED_SCALAR", "1")
    scalar = hls.Session(device="cpu").compile(_conv_build(frontend))
    assert scalar.design_hash == port.design_hash
    assert scalar.makespan == port.makespan
    assert list(scalar.schedule.start) == list(port.schedule.start)


# ---------------------------------------------------------------------------
# What the port renamed or left out
# ---------------------------------------------------------------------------

def test_cache_root_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    assert cachedir.default_cache_base().name.startswith("repro_torch_cache_")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "reference"))
    assert "reference" not in str(cachedir.default_cache_base())
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "port"))
    root = cachedir.cache_root("designs")
    assert root == tmp_path / "port" / f"v{cachedir.CACHE_FORMAT_VERSION}" \
        / "designs"


def test_unported_emission_paths_say_where_they_wait(conv_pair):
    # the simd backend and the generic DFG tier have landed: a design
    # without a ModuleGraph emits through both
    _, port = conv_pair
    g = port.graph_opt
    assert emit.to_torch_fn(g, backend="simd", device="cpu").device.type \
        == "cpu"
    assert emit.to_torch_fn(g, backend="cuda", device="cpu").plan.mode \
        == "dfg"
    with pytest.raises(TypeError, match="only device="):
        emit.to_torch_fn(g, backend="simd", fmt="5_4")
    with pytest.raises(ValueError, match="unknown emission backend"):
        port.torch_fn(backend="pallas")
    assert emit.EMIT_BACKENDS == ("simd", "cuda")


def test_pipeline_has_torch_fn_and_no_shims():
    assert hasattr(pipeline.CompiledDesign, "torch_fn")
    assert not hasattr(pipeline.CompiledDesign, "jax_fn")
    assert not hasattr(pipeline, "compile")
    assert not hasattr(pipeline, "default_driver")


# ---------------------------------------------------------------------------
# Imports: torch and numpy, never jax or the reference package
# ---------------------------------------------------------------------------

def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_runtime_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.hls, repro_torch.models.braggnn\n"
            "import repro_torch.core.emit_cuda, repro_torch.kernels.build\n"
            "import repro_torch.models.transformer, repro_torch.tune.cli\n"
            "import repro_torch.optim.adamw, repro_torch.optim.compress\n"
            "import repro_torch.data.pipeline, repro_torch.checkpoint.ckpt\n"
            "import repro_torch.runtime.fault\n"
            "import repro_torch.models.lm, repro_torch.serving.engine\n"
            "import repro_torch.launch.serve, repro_torch.nn.moe\n"
            "import repro_torch.configs.qwen2_moe_a27b\n"
            "import repro_torch.configs.mixtral_8x7b\n"
            "import repro_torch.nn.rglru\n"
            "import repro_torch.configs.recurrentgemma_9b\n"
            "import repro_torch.nn.xlstm, repro_torch.configs.xlstm_1_3b\n"
            "import repro_torch.kernels.slstm_scan.ops\n"
            "import repro_torch.models.encdec\n"
            "import repro_torch.configs.whisper_tiny\n"
            "import repro_torch.examples.serve_moe\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.braggnn_serve\n"
            "import repro_torch.configs.qwen2_vl_2b\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.examples.train_lm\n"
            "import repro_torch.core.binding, repro_torch.launch.mesh\n"
            "import repro_torch.launch.shardings\n"
            "import repro_torch.runtime.elastic\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.launch.op_inventory\n"
            "import repro_torch.launch.hillclimb\n"
            "import repro_torch.nn.transformer\n"
            "import repro_torch.nn.tensor_parallel\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
