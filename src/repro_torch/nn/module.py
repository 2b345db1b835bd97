"""Parameter specs and their materialisation as torch tensors.

Every parameter is declared by a ``ParamSpec`` carrying its shape and a
tuple of *logical axis names* (kept from the reference for the sharded
slices to come).  Specs compose as plain nested dicts; :func:`init_tree`
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


def init_tree(specs: SpecTree, generator: torch.Generator) -> Any:
    """Materialise parameters (CPU tensors) from one seeded generator."""
    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype)
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(
            spec.fan_in())
        return (torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32) * std).to(spec.dtype)
    return map_specs(make, specs)


def param_count(specs: SpecTree) -> int:
    counts: list[int] = []
    map_specs(lambda s: counts.append(int(np.prod(s.shape))), specs)
    return sum(counts)
