"""Plain PyTorch version of smallfloat_matmul: quantise, then ``@``."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import FloatFormat, quantize


def smallfloat_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None, *,
                          exp_bits: Optional[int] = 5,
                          man_bits: Optional[int] = 4,
                          fuse_relu: bool = False,
                          out_fmt: Optional[tuple[int, int]] = None
                          ) -> torch.Tensor:
    xq, wq = x.to(torch.float32), w.to(torch.float32)
    if exp_bits is not None:      # None = plain fp32 (no quantisation)
        fmt = FloatFormat(exp_bits, man_bits)
        xq = quantize(xq, fmt)
        wq = quantize(wq, fmt)
    out = xq @ wq
    if b is not None:
        out = out + b.to(torch.float32)
    if fuse_relu:
        out = torch.relu(out)
    if out_fmt is not None:
        out = quantize(out, FloatFormat(*out_fmt))
    return out
