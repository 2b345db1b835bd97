"""The binding rules and the sharding resolution of the port
(``repro_torch.core.binding``, ``repro_torch.launch.shardings``), held
against the reference's on meshes given by their shapes alone: pure
logic, no processes.

For every architecture of the registry, on the 16 x 16 and 2 x 16 x 16
production meshes and on 2 x 2 and 1 x 1, each parameter's and each
AdamW state leaf's spec (the rules' spec, then pruned by divisibility),
its replication factor K and the bytes per device equal the reference's
``BindingRules.spec`` + ``prune_spec`` on a duck-typed mesh, leaf by leaf,
exactly.  Also ``with_overrides``, the placements and blocks of a
sharding, and ``input_specs``/``input_axes`` for every kind of shape.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.binding import BindingRules, NamedSharding, \
    P  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.nn import module, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH_QWEN = "qwen2.5-3b"
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x2": {"data": 2, "model": 2},
    "1x1": {"data": 1, "model": 1},
}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from jax.sharding import PartitionSpec
    from repro.configs import registry as ref_registry
    from repro.core import binding as ref_binding
    from repro.launch import shardings as ref_sh
    from repro.models import encdec as ref_encdec
    from repro.nn import module as ref_module
    from repro.nn import transformer as ref_tr
    from repro.optim import adamw as ref_adamw
    return types.SimpleNamespace(
        P=PartitionSpec, registry=ref_registry, binding=ref_binding,
        sh=ref_sh, encdec=ref_encdec, module=ref_module, tr=ref_tr,
        adamw=ref_adamw)


class _FakeMesh:
    """Duck-typed mesh for the reference: its rules read ``.shape``."""

    def __init__(self, shape: dict):
        self.shape = shape


def _mesh(name):
    """The port's mesh of that shape: the production meshes as
    ``make_production_mesh`` gives them, the small ones shape-only."""
    if name == "16x16":
        return mesh_lib.make_production_mesh()
    if name == "2x16x16":
        return mesh_lib.make_production_mesh(multi_pod=True)
    return mesh_lib.Mesh(MESHES[name])


def _walk(tree, prefix=""):
    """{path: leaf} of a nested dict (axes tuples and tensors leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_walk(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _specs(cfg, pkg):
    return pkg.encdec.model_specs(cfg) if cfg.is_encoder_decoder else \
        pkg.tr.model_specs(cfg)


def _port_pkg():
    return types.SimpleNamespace(encdec=encdec, tr=transformer)


def _trees(ref, arch, state):
    """(port abstract, port axes, ref abstract, ref axes) of an arch's
    parameters, or of their AdamW state."""
    pc, rc = registry.get_config(arch), ref.registry.get_config(arch)
    ps, rs = _specs(pc, _port_pkg()), _specs(rc, ref)
    pa, px = module.abstract_tree(ps), module.axes_tree(ps)
    ra, rx = ref.module.abstract_tree(rs), ref.module.axes_tree(rs)
    if state:
        pa, px = adamw.abstract_state(pa), adamw.state_axes(px)
        ra, rx = ref.adamw.abstract_state(ra), ref.adamw.state_axes(rx)
    return pc, pa, px, ra, rx


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
@pytest.mark.parametrize("tree", ["params", "adamw_state"])
def test_specs_K_and_bytes_match_reference(ref, arch, mesh_name, tree):
    pc, pa, px, ra, rx = _trees(ref, arch, tree == "adamw_state")
    mesh, fake = _mesh(mesh_name), _FakeMesh(MESHES[mesh_name])
    assert mesh.shape == fake.shape and list(mesh.shape) == list(fake.shape)
    rules = sh.rules_for(pc)
    r_rules = ref.sh.rules_for(ref.registry.get_config(arch))
    p_abs, p_axes = _walk(pa), _walk(px)
    r_abs, r_axes = _jax_walk(ra), _jax_walk(rx)
    assert list(p_axes) == list(r_axes) == list(p_abs) == list(r_abs)
    port_sh = sh.tree_shardings(pa, px, mesh, rules)
    got_sh = _walk(port_sh)
    duck = {}
    for path, axes in p_axes.items():
        assert axes == r_axes[path]
        shape = tuple(p_abs[path].shape)
        assert shape == tuple(r_abs[path].shape)
        want = ref.sh.prune_spec(shape, r_rules.spec(axes, fake), fake)
        got = got_sh[path]
        assert isinstance(got, NamedSharding) and got.mesh is mesh
        assert tuple(got.spec) == tuple(want), path
        assert tuple(rules.spec(axes, mesh)) == tuple(
            r_rules.spec(axes, fake))
        assert rules.K(axes, mesh) == r_rules.K(axes, fake)
        duck[path] = types.SimpleNamespace(spec=want, mesh=fake)
    want_bytes = ref.sh.bytes_per_device(ra, _jax_unwalk(duck, ra))
    assert sh.bytes_per_device(pa, port_sh) == want_bytes
    assert want_bytes > 0


def _jax_walk(tree):
    """{path: leaf} of a reference tree (nested dicts), axes tuples kept
    whole."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            for p, v in _jax_walk(tree[k]).items():
                out[f"{k}/{p}" if p else k] = v
        return out
    return {"": tree}


def _jax_unwalk(flat: dict, like):
    """The nested dict of ``like``'s structure with ``flat``'s leaves."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(t[k], f"{prefix}{k}/") for k in t}
        return flat[prefix[:-1]]
    return build(like, "")


def test_reference_rules_examples():
    """The reference's own examples (``tests/test_binding_shardings.py``)
    on the port's rules and production meshes."""
    r = BindingRules()
    m, m3 = mesh_lib.make_production_mesh(), \
        mesh_lib.make_production_mesh(multi_pod=True)
    assert r.spec(("batch", None), m3) == P(("pod", "data"), None)
    assert r.spec(("embed", "mlp"), m) == P(None, "model")
    assert r.spec(("experts", "embed", "expert_mlp"), m) == \
        P("model", None, None)
    assert r.K(("batch",), m3) == 32
    assert r.K(("heads", None), m) == 16
    assert r.K((None, None), m) == 1
    assert sh.prune_spec((1, 128), P("data", None), m) == P(None, None)
    assert sh.prune_spec((60, 64), P("model", None), m) == P(None, None)
    assert sh.prune_spec((32,), P(("pod", "data")), m3) == P(("pod", "data"))
    assert sh.prune_spec((2,), P(("pod", "data")), m3) == P("pod")


@pytest.mark.parametrize("overrides", [
    dict(embed="model"),
    dict(heads=None, head_dim="model"),
    dict(experts=None, expert_mlp="model", batch="data"),
])
def test_with_overrides_matches_reference(ref, overrides):
    got = BindingRules().with_overrides(**overrides)
    want = ref.binding.BindingRules().with_overrides(**overrides)
    assert got.rules == want.rules
    for name, shape in MESHES.items():
        fake = _FakeMesh(shape)
        for axes in (("embed", "mlp"), ("embed", "heads", "head_dim"),
                     ("experts", "embed", "expert_mlp"), ("batch", None),
                     ("vocab", "embed")):
            assert tuple(got.spec(axes, fake)) == tuple(want.spec(axes,
                                                                  fake))
            assert got.K(axes, fake) == want.K(axes, fake)


def test_tree_shardings_of_an_axes_tree_match_reference(ref):
    """``binding.tree_shardings``: the rules' specs, unpruned, over a
    whole axes tree."""
    from repro_torch.core import binding
    cfg = registry.get_config(ARCH_QWEN)
    px = module.axes_tree(transformer.model_specs(cfg))
    rx = ref.module.axes_tree(ref.tr.model_specs(
        ref.registry.get_config(ARCH_QWEN)))
    mesh, fake = _mesh("16x16"), _FakeMesh(MESHES["16x16"])
    rules = sh.rules_for(cfg)
    got = _walk(binding.tree_shardings(px, mesh, rules))
    r_rules = ref.sh.rules_for(ref.registry.get_config(ARCH_QWEN))
    want = _jax_walk(rx)
    assert list(got) == list(want)
    for path, s in got.items():
        assert s.mesh is mesh
        assert tuple(s.spec) == tuple(r_rules.spec(want[path], fake))


def test_placements_and_blocks():
    """Placements per mesh dimension, in mesh order; each coordinate's
    block, the first axis of a multi-axis entry outermost; blocks tile
    the tensor."""
    from torch.distributed.tensor import Replicate, Shard
    m3 = mesh_lib.Mesh({"pod": 2, "data": 2, "model": 2})
    s = NamedSharding(m3, P(("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(m3, P()).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        NamedSharding(m3, P(("data", "pod"))).placements
    seen = np.zeros((8, 3, 4), int)
    for c in np.ndindex(2, 2, 2):
        b = s.block((8, 3, 4), c)
        assert b[0] == slice(2 * (2 * c[0] + c[1]), 2 * (2 * c[0] + c[1])
                             + 2)
        seen[b] += 1
    assert (seen == 1).all()         # the blocks tile the tensor
    with pytest.raises(ValueError, match="does not divide"):
        s.block((6, 3, 4), (0, 0, 0))


@pytest.mark.parametrize("shape_name", list(registry.SHAPES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_and_axes_match_reference(ref, arch, shape_name):
    pc, rc = registry.get_config(arch), ref.registry.get_config(arch)
    shape = registry.SHAPES[shape_name]
    got, want = registry.input_specs(pc, shape), \
        ref.registry.input_specs(rc, ref.registry.SHAPES[shape_name])
    assert list(got) == list(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    assert registry.input_axes(pc, shape) == ref.registry.input_axes(
        rc, ref.registry.SHAPES[shape_name])


def test_production_mesh_with_devices_names_the_world_it_needs():
    with pytest.raises(RuntimeError, match="256"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512"):
        mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
