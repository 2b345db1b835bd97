"""Plain PyTorch version of conv2d_vmem (valid padding, stride 1, NCHW)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.precision import FloatFormat, quantize


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, *,
               fmt: Optional[tuple[int, int]] = None,
               fuse_relu: bool = False,
               out_fmt: Optional[tuple[int, int]] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = _round(x.to(torch.float32), fmt)
    w = _round(w.to(torch.float32), fmt)
    out = F.conv2d(x, w)
    if b is not None:
        out = out + b.to(torch.float32)[None, :, None, None]
    if fuse_relu:
        out = torch.relu(out)
    out = _round(out, out_fmt)
    if residual is not None:
        out = _round(residual.to(torch.float32) + out, out_fmt)
    return out


def _round(t: torch.Tensor, fmt: Optional[tuple[int, int]]) -> torch.Tensor:
    return quantize(t, FloatFormat(*fmt)) if fmt is not None else t
