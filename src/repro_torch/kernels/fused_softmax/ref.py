"""Plain PyTorch version of fused_softmax: the max, exp and sum written out,
and the Taylor series."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import FloatFormat, quantize


def taylor_exp_ref(x: torch.Tensor, order: int, range_reduce: int
                   ) -> torch.Tensor:
    y = x.to(torch.float32) / float(1 << range_reduce)
    acc = torch.ones_like(y)
    term = torch.ones_like(y)
    for k in range(1, order + 1):
        term = term * y / float(k)
        acc = acc + term
    for _ in range(range_reduce):
        acc = acc * acc
    return acc


def fused_softmax_ref(x: torch.Tensor, *, taylor_order: int = 0,
                      range_reduce: int = 2,
                      in_fmt: Optional[tuple[int, int]] = None
                      ) -> torch.Tensor:
    xf = x.to(torch.float32)
    if in_fmt is not None:
        xf = quantize(xf, FloatFormat(*in_fmt))
    z = xf - torch.amax(xf, dim=-1, keepdim=True)
    e = (taylor_exp_ref(z, taylor_order, range_reduce) if taylor_order
         else torch.exp(z))
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)
