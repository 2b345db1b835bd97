"""Where the port runs: a CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]
#: a CPU batch of fewer samples runs on one intra-op thread: on an idle
#: CPU, BraggNN at img 11 runs no slower so up to 16 and faster on the
#: whole pool from 32 (``tools/drain_under_load.py``)
SERIAL_CPU_BATCH = 16


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch device for ``device`` (default ``"cuda"``).

    There is no guess: without a GPU the default raises, and the CPU — where
    every kernel runs its plain PyTorch version — is taken only when asked
    for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the "
            "CPU (plain PyTorch versions of the kernels)")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the card's queued work (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


#: intra-op threads are a process setting: entries into
#: :func:`host_threads` are counted so the outermost exit restores it
_THREADS_LOCK = threading.Lock()
_serial = {"depth": 0, "pool": 0}


@contextlib.contextmanager
def host_threads(device: Optional[torch.device], batch: int,
                 serial_below: int = SERIAL_CPU_BATCH) -> Iterator:
    """Run a CPU batch of fewer than ``serial_below`` samples on one
    intra-op thread (no-op on the card and for larger batches).

    A small batch's ops are microseconds each, and every parallel region
    waits for the whole thread pool: on a CPU shared with other busy
    processes each wait can cost a scheduler slice
    (``tools/drain_under_load.py``).  Threads may overlap here: the pool's
    size is read by the first to enter and every exit sets it back, so
    the process never keeps one thread after the last exit."""
    if device is None or device.type != "cpu" or batch >= serial_below:
        yield
        return
    with _THREADS_LOCK:
        if _serial["depth"] == 0:
            _serial["pool"] = torch.get_num_threads()
        _serial["depth"] += 1
        torch.set_num_threads(1)
    try:
        yield
    finally:
        with _THREADS_LOCK:
            _serial["depth"] -= 1
            torch.set_num_threads(_serial["pool"])


def capturing(device: Optional[torch.device]) -> bool:
    """Whether work on ``device`` is being captured into a CUDA graph now
    (a synchronise would then break the capture)."""
    return (device is not None and device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def to_host(tree):
    """A tensor (any device), array, or dict of them, as numpy on the host:
    a copy of a captured graph's outputs that its next replay leaves
    alone, or what an artifact pickles."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
