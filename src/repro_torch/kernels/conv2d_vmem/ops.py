"""Public wrapper for the weights-resident conv: the plain version for a
CPU tensor, the CUDA kernel for a CUDA tensor."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.conv2d_vmem.conv2d_vmem import conv2d_vmem
from repro_torch.kernels.conv2d_vmem.ref import conv2d_ref


def conv2d(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           fmt: Optional[tuple[int, int]] = None,
           fuse_relu: bool = False,
           out_fmt: Optional[tuple[int, int]] = None,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    kw = {"fmt": fmt, "fuse_relu": fuse_relu, "out_fmt": out_fmt,
          "residual": residual}
    if x.device.type == "cpu":
        return conv2d_ref(x, w, b, **kw)
    return conv2d_vmem(x, w, b, **kw)
