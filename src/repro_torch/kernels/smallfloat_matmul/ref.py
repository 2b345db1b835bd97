"""Plain PyTorch version of smallfloat_matmul: quantise, then ``@``; a
chain is the composition of its layers."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.precision import FloatFormat, quantize


class Dense(NamedTuple):
    """One layer of a chain: ``x @ w + b``, then ReLU, then the result
    rounded to ``out_fmt``."""

    w: torch.Tensor                         #: (K, N), any strides
    b: Optional[torch.Tensor] = None        #: (N,) fp32
    relu: bool = False
    out_fmt: Optional[tuple[int, int]] = None


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


def smallfloat_matmul_chain_ref(x: torch.Tensor, layers: Sequence[Dense], *,
                                exp_bits: Optional[int] = 5,
                                man_bits: Optional[int] = 4) -> torch.Tensor:
    """The layers one after another, each through
    :func:`smallfloat_matmul_ref`."""
    for ly in layers:
        x = smallfloat_matmul_ref(x, ly.w, ly.b, exp_bits=exp_bits,
                                  man_bits=man_bits, fuse_relu=ly.relu,
                                  out_fmt=ly.out_fmt)
    return x
