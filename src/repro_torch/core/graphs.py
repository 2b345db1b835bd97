"""Captured CUDA graphs for the serving runners: the port's counterpart of
the reference's ``jax.jit`` on the serve path.

A :class:`GraphRunner` wraps one call, ``feeds -> outputs`` (feeds: name
-> array or tensor).  It serves the designs' batches (fp32), the LM
engine's decode step (int64 tokens and positions) and BraggNN's training
step (fp32 leaves and an int32 step count).  On a CUDA device it keeps one
captured graph for each batch shape, the names and shapes of the feeds:

* **First call of a shape.**  A static input tensor is allocated for each
  feed, in the feed's dtype (a numpy array of floats: fp32, the designs'
  memref type), and the batch is copied into it.  The call runs once
  eagerly on the static inputs, on the capture's side stream: the
  warm-up, which builds the kernel library, makes K4's first-call
  occupancy query, runs the profile twin if ``obs`` asks for it and
  starts autograd's device thread, all outside any capture (PyTorch's
  whole-network capture wants its warm-up on a side stream).  Then the
  call is captured into a graph, in a memory pool shared by all of the
  runner's graphs.  This first call returns the eager outputs.
* **Every later call of the shape** copies the batch into the static
  inputs (:func:`copy_all`: a launch or two for all of them) and
  replays the graph.  It returns the graph's static outputs, which the
  next replay of any of the runner's graphs overwrites: a caller that
  keeps them copies them first.

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


def _as_tensor(v) -> torch.Tensor:
    """A feed as a tensor: tensors as they are, numpy floats as fp32 (the
    designs' memref type), other numpy arrays in their own dtype."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.kind == "f":
        a = a.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a))


def copy_all(dsts: list, srcs: list) -> None:
    """``dst.copy_(src)`` for each pair, with one ``torch._foreach_copy_``
    per kind of pair (dtypes and source device): its fast route, a launch
    or two for all, takes lists of one dtype only."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        ds, ss = groups.setdefault((d.dtype, s.dtype, s.device), ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


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
            copy_all([cap.inputs[n] for n in feeds],
                     [_as_tensor(v) for v in feeds.values()])
            cap.graph.replay()
            registry.add_launch_counts(cap.launches)
            return cap.outputs

    def _capture(self, key: tuple, feeds: dict):
        static = {}
        for name, v in feeds.items():
            v = _as_tensor(v)
            static[name] = torch.empty(v.shape, dtype=v.dtype,
                                       device=self.device)
            static[name].copy_(v)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self._pool,
                                   capture_error_mode="thread_local")
        # the warm-up runs on the stream the capture uses, one for every
        # runner of the process: a side stream per runner would give each
        # its own per-stream resources (cuBLAS's workspace)
        main, side = torch.cuda.current_stream(), capture.capture_stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._call(static)              # the eager warm-up
        main.wait_stream(side)
        before = registry.launch_counts()
        try:
            with capture:
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
