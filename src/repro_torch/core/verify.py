"""Testbench inputs: memref shapes and seeded random feeds.

The numpy half of the reference's ``core/verify.py`` that the compile path
uses (the pass manager's spot-verify hook, the front door's input
inference).  ``run_testbench`` comes with a later slice.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.ir import Graph


def input_shapes(g: Graph) -> dict[str, tuple[int, ...]]:
    """Reconstruct memref shapes from interface tables (max index + 1)."""
    shapes = {}
    for name, table in g.inputs.items():
        rank = len(next(iter(table)))
        shapes[name] = tuple(max(i[d] for i in table) + 1 for d in range(rank))
    return shapes


def random_feeds(g: Graph, *, batch: int = 4, seed: int = 0,
                 scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    feeds = {}
    for name, shape in input_shapes(g).items():
        feeds[name] = rng.normal(0.0, scale, size=(batch,) + shape).astype(
            np.float32)
    return feeds
