"""Captured CUDA graphs for the serving runners: the port's counterpart of
the reference's ``jax.jit`` on the serve path.

A :class:`GraphRunner` wraps one call, ``feeds -> outputs`` (feeds: memref
name -> fp32 array or tensor).  On a CUDA device it keeps one captured
graph for each batch shape, the names and shapes of the feeds:

* **First call of a shape.**  A static input tensor is allocated for each
  fed memref and the batch is copied into it.  The call runs once eagerly
  on the static inputs: the warm-up, which builds the kernel library,
  makes K4's first-call occupancy query, and runs the profile twin if
  ``obs`` asks for it, all outside any capture.  Then the call is captured
  into a graph, in a memory pool shared by all of the runner's graphs.
  This first call returns the eager outputs.
* **Every later call of the shape** copies the batch into the static
  inputs (the only host-to-device copy) and replays the graph.  It returns
  the graph's static outputs, which the next replay of any of the
  runner's graphs overwrites: a caller that keeps them copies them first.

The kernels' wrappers count their launches in Python, which a replay does
not run.  So the counts a capture made are taken back (nothing ran on the
card), recorded for that graph, and added again on each replay.

A capture that fails raises; there is no eager fallback on the card.  On
the CPU the call runs eagerly on the feeds as given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import registry


@dataclasses.dataclass
class _Captured:
    graph: Any                       #: torch.cuda.CUDAGraph
    inputs: dict                     #: memref name -> static input tensor
    outputs: Any                     #: the graph's static outputs
    launches: dict                   #: kernel name -> launches per replay


def _shape(v) -> tuple[int, ...]:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _copy_into(dst: torch.Tensor, v) -> None:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    dst.copy_(v)


class GraphRunner:
    """``call`` replayed as one captured CUDA graph per batch shape on
    ``device``, or run eagerly on the CPU (see the module docstring)."""

    def __init__(self, call: Callable[[dict], Any], device: torch.device):
        self._call = call
        self.device = device
        if device.type == "cuda" and device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._graphs: dict[tuple, _Captured] = {}
        self._pool = None

    def __call__(self, feeds: dict):
        if self.device.type != "cuda":
            return self._call(feeds)
        key = tuple(sorted((n, _shape(v)) for n, v in feeds.items()))
        # the engine's dispatcher thread replays what the booting thread
        # captured: pin the device on whichever thread calls
        with torch.cuda.device(self.device):
            cap = self._graphs.get(key)
            if cap is None:
                return self._capture(key, feeds)
            for name, v in feeds.items():
                _copy_into(cap.inputs[name], v)
            cap.graph.replay()
            registry.add_launch_counts(cap.launches)
            return cap.outputs

    def _capture(self, key: tuple, feeds: dict):
        static = {name: torch.empty(shape, dtype=torch.float32,
                                    device=self.device)
                  for name, shape in key}
        for name, v in feeds.items():
            _copy_into(static[name], v)
        out = self._call(static)                  # the eager warm-up
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = registry.launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                outputs = self._call(static)
        finally:
            after = registry.launch_counts()
            launched = {k: n - before[k] for k, n in after.items()
                        if n != before[k]}
            registry.add_launch_counts({k: -n for k, n in launched.items()})
        self._graphs[key] = _Captured(graph, static, outputs, launched)
        return out

    def replay_launches(self) -> dict[tuple, dict[str, int]]:
        """Batch shape -> kernel launches that one replay of its graph
        makes."""
        return {key: dict(cap.launches) for key, cap in self._graphs.items()}

    def release(self) -> None:
        """Drop every captured graph and its static tensors, returning the
        pool's memory to the caching allocator."""
        for cap in self._graphs.values():
            cap.graph.reset()
        self._graphs.clear()
        self._pool = None
