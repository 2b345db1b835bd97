"""Argument checks shared by the kernel launch wrappers."""

from __future__ import annotations

from typing import Optional

import torch


def require(t: torch.Tensor, name: str, *, ndim: int,
            dtypes: tuple = (torch.float32,), contiguous: bool = True
            ) -> None:
    """Raise unless ``t`` is a CUDA tensor of the given rank and dtype."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def same_device(ref: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    for o in others:
        if o is not None and o.device != ref.device:
            raise ValueError(f"operands on {ref.device} and {o.device}")


def fmt_args(fmt: Optional[tuple[int, int]]) -> tuple[int, int]:
    """(exp_bits, man_bits) for the C entry points; (-1, -1) is fp32."""
    if fmt is None:
        return -1, -1
    eb, mb = int(fmt[0]), int(fmt[1])
    if not (2 <= eb <= 8 and 0 <= mb <= 22):
        raise ValueError(f"format {fmt} outside the kernels' range "
                         f"(2 <= wE <= 8, 0 <= wF <= 22)")
    return eb, mb
