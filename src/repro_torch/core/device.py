"""Where the port runs: a CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

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
