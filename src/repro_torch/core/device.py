"""Where the port runs: a CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


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
