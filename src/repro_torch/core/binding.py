"""Resource binding at scale: parallel axes -> mesh axes (paper §3.3).

On the FPGA, OpenHLS binds the instances of an scf.parallel iteration
space to K_i functional units.  Across devices the functional units are
cards, and the binding is a sharding: each *named* parallel axis of a
tensor (batch, heads, experts, ...) binds to a mesh axis through a rule
table, and K_i = the product of the bound mesh axes' sizes is the
replication factor: the paper's K_i, counted over devices instead of DSPs.

The reference's ``repro.core.binding`` in torch.  Model code annotates
parameters with *logical* axis names (``ParamSpec.axes``), and the
launcher resolves them against a mesh through these rules.  The rules read
only ``mesh.shape``, an ordered mapping from axis name to size, so specs
and replication factors come out for a 16 x 16 or 2 x 16 x 16 mesh with no
devices behind it.

:class:`PartitionSpec` is the reference's ``jax.sharding.PartitionSpec``:
one entry per tensor dimension, each None (whole), a mesh axis name, or a
tuple of names (outer first).  :class:`NamedSharding` pairs a spec with a
mesh and gives its DTensor placements (``Shard(d)`` or ``Replicate()`` per
mesh dimension) and the block of a tensor that the device at a mesh
coordinate holds: the block JAX's ``devices_indices_map`` gives the same
device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

MeshAxes = Union[None, str, tuple[str, ...]]


#: Default rule table for the production mesh (pod, data, model).
#: First matching rule wins.  ``None`` = replicated along that logical axis.
DEFAULT_RULES: tuple[tuple[str, MeshAxes], ...] = (
    ("batch", ("pod", "data")),   # DP across pods and the data axis
    ("seq", None),                # sequence replicated in train (SP opt-in)
    ("seq_shard", "data"),        # context/sequence parallelism (opt-in)
    ("embed", None),              # activations' feature dim replicated
    ("heads", "model"),           # TP over attention heads
    ("kv_heads", "model"),        # TP over KV heads (GQA)
    ("qkv", None),
    ("mlp", "model"),             # TP over FFN hidden (Megatron column)
    ("mlp_in", "model"),
    ("experts", "model"),         # EP: experts bound to the model axis
    ("expert_mlp", None),         # within-expert hidden replicated under EP
    ("expert_embed", None),       # FSDP opt-in for huge replicated experts
    ("vocab", "model"),           # TP over the embedding/vocab dim
    ("kv_batch", ("pod", "data")),  # KV cache batch dim
    ("layers", None),             # stacked-layer leading dim
    ("conv", None),
    ("head_dim", None),           # per-arch overrides bind this to model
    ("opt_embed", "data"),        # ZeRO: optimizer state also shards the
                                  # embed dim over data (see optim.adamw)
)


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, a mesh axis, or a tuple of
    mesh axes (outer first).  A tuple, so it compares equal to the
    reference's ``PartitionSpec`` turned into one."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def entry_axes(entry: MeshAxes) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outer first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``launch.mesh.Mesh``, or anything with an
    ordered ``shape`` mapping axis -> size)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """The DTensor placements, one per mesh dimension in mesh order:
        ``Shard(d)`` where tensor dim ``d`` is split over that mesh axis,
        else ``Replicate()``.  DTensor splits a dimension over several
        mesh dimensions in mesh order, so an entry's axes must come in
        mesh order (as ``("pod", "data")`` does) to mean the same block."""
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(self.mesh.shape)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            axes = entry_axes(entry)
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(
                    f"{self.spec}: entry {entry} is not in the mesh's axis "
                    f"order {names}, which DTensor's placements cannot say")
            for a in axes:
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def block(self, shape: Sequence[int], coordinate: Sequence[int]
              ) -> tuple[slice, ...]:
        """The slices of a tensor of ``shape`` that the device at mesh
        ``coordinate`` (one index per mesh axis, in mesh order) holds:
        each dimension split into equal blocks over its entry's axes,
        the first axis outermost.  The spec must divide the shape (see
        ``launch.shardings.prune_spec``)."""
        names = tuple(self.mesh.shape)
        where = dict(zip(names, coordinate))
        out = []
        for d, size in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            index, parts = 0, 1
            for a in entry_axes(entry):
                index = index * self.mesh.shape[a] + where[a]
                parts *= self.mesh.shape[a]
            if size % parts:
                raise ValueError(f"{self.spec} does not divide {tuple(shape)}"
                                 f": dim {d} of {size} into {parts}")
            n = size // parts
            out.append(slice(index * n, (index + 1) * n))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class BindingRules:
    rules: tuple[tuple[str, MeshAxes], ...] = DEFAULT_RULES

    def mesh_axes_for(self, logical: Optional[str], mesh) -> MeshAxes:
        if logical is None:
            return None
        for name, target in self.rules:
            if name != logical:
                continue
            if target is None:
                return None
            present = tuple(a for a in entry_axes(target) if a in mesh.shape)
            if not present:
                return None
            return present if len(present) > 1 else present[0]
        return None

    def spec(self, logical_axes: Sequence[Optional[str]], mesh
             ) -> PartitionSpec:
        """PartitionSpec for an array annotated with logical axis names;
        a mesh axis goes to the first dimension that asks for it."""
        used: set[str] = set()
        out: list[MeshAxes] = []
        for ax in logical_axes:
            fresh = tuple(a for a in entry_axes(self.mesh_axes_for(ax, mesh))
                          if a not in used)
            used.update(fresh)
            if not fresh:
                out.append(None)
            elif len(fresh) == 1:
                out.append(fresh[0])
            else:
                out.append(fresh)
        return PartitionSpec(*out)

    def sharding(self, logical_axes: Sequence[Optional[str]], mesh
                 ) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_axes, mesh))

    def K(self, logical_axes: Sequence[Optional[str]], mesh) -> int:
        """Replication factor K_i of a binding (paper §3.3): the number of
        devices an op's parallel iteration space is spread across."""
        k = 1
        for entry in self.spec(logical_axes, mesh):
            for a in entry_axes(entry):
                k *= mesh.shape[a]
        return k

    def with_overrides(self, **overrides: MeshAxes) -> "BindingRules":
        """New rules with some logical axes re-bound (hillclimbing)."""
        new = tuple(overrides.items())
        rest = tuple((k, v) for k, v in self.rules if k not in overrides)
        return BindingRules(new + rest)


def is_axes(x) -> bool:
    """Whether ``x`` is one leaf of an axes tree: a tuple of logical axis
    names (or None)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def map_axes(fn, tree):
    """Apply ``fn`` to every axes tuple of a nested dict."""
    if is_axes(tree):
        return fn(tree)
    return {k: map_axes(fn, v) for k, v in tree.items()}


def tree_shardings(axes_tree, mesh, rules: Optional[BindingRules] = None):
    """Map a nested dict of logical-axes tuples to NamedShardings."""
    rules = rules or BindingRules()
    return map_axes(lambda axes: rules.sharding(axes, mesh), axes_tree)
