"""Parameter specs and their materialisation as torch tensors.

Every parameter is declared by a ``ParamSpec`` carrying its shape and a
tuple of *logical axis names*, which ``core.binding``'s rules resolve to
mesh axes.  Specs compose as plain nested dicts; :func:`init_tree`
walks them in sorted key order and draws from one ``torch.Generator``, so a
seed fixes every tensor.  The draws differ from ``jax.random``'s for the
same seed: tests that compare the two packages hand both the same numpy
weights instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

Axes = tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: Axes
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # stddev; None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")

    def fan_in(self) -> int:
        if len(self.shape) <= 1:
            return max(self.shape[0] if self.shape else 1, 1)
        return int(np.prod(self.shape[:-1]))


SpecTree = Any  # nested dict of ParamSpec


def map_specs(fn: Callable[[ParamSpec], Any], specs: SpecTree) -> Any:
    """Apply ``fn`` to every spec of a nested dict, in sorted key order."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, specs[k]) for k in sorted(specs)}


def init_tree(specs: SpecTree, generator: torch.Generator, *,
              device=None) -> Any:
    """Materialise parameters from one seeded generator, drawn on
    ``device`` (default: the CPU), where ``generator`` must live too: a
    model of billions of parameters is drawn where it runs, not copied
    there."""
    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(
            spec.fan_in())
        return torch.randn(spec.shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(std).to(spec.dtype)
    return map_specs(make, specs)


def abstract_tree(specs: SpecTree) -> Any:
    """Stand-ins with each spec's shape and dtype on the ``meta`` device
    (the reference's ``ShapeDtypeStruct``s): no storage."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), specs)


def axes_tree(specs: SpecTree) -> Any:
    """The logical-axes tree matching the param tree's structure."""
    return map_specs(lambda s: s.axes, specs)


def stack(specs: SpecTree, n: int) -> SpecTree:
    """Prepend a ``layers`` dimension of ``n`` to every spec: the stacked
    parameters of ``n`` layers of one kind."""
    return map_specs(
        lambda s: dataclasses.replace(
            s, shape=(n,) + s.shape, axes=("layers",) + s.axes), specs)


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict (a param tree)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)`` of a tree of dicts, lists and tuples.

    Leaves come in the reference's pytree order (dict keys sorted,
    sequences in order), so a checkpoint's ``leaf_%05d`` files line up
    between the two packages.  :func:`tree_unflatten` rebuilds the tree.
    """
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return (dict, keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t), None, tuple(walk(v) for v in t))
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    """The tree ``treedef`` describes, with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, kids = d
        if kind is dict:
            return {k: build(c) for k, c in zip(keys, kids)}
        return kind(build(c) for c in kids)

    return build(treedef)


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def params_from_numpy(tree: Any, device=None) -> Any:
    """A nested dict of arrays (e.g. the JAX package's parameters as numpy)
    -> the same tree of fp32 tensors on ``device`` (default: the CPU)."""
    return map_tree(lambda a: torch.tensor(np.asarray(a, dtype=np.float32),
                                           device=device), tree)


def param_count(specs: SpecTree) -> int:
    counts: list[int] = []
    map_specs(lambda s: counts.append(int(np.prod(s.shape))), specs)
    return sum(counts)


def param_bytes(specs: SpecTree) -> int:
    sizes: list[int] = []
    map_specs(lambda s: sizes.append(int(np.prod(s.shape))
                                     * s.dtype.itemsize), specs)
    return sum(sizes)
