"""Launch wrapper for the CUDA row-softmax kernel
(``csrc/fused_softmax.cu``).

Softmax over the last axis of a 2-D fp32 array, with true exp
(``taylor_order=0``) or the paper's Taylor-series exp, the input optionally
rounded to a (wE, wF) format as it is read.
``fused_softmax.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import fmt_args, require


def fused_softmax(x: torch.Tensor, *, taylor_order: int = 0,
                  range_reduce: int = 2,
                  in_fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """x: contiguous fp32 (rows, cols) on a CUDA device -> same shape;
    ``in_fmt`` rounds each input value to that format first."""
    require(x, "x", ndim=2)
    if taylor_order < 0 or not 0 <= range_reduce < 31:
        raise ValueError(f"taylor_order {taylor_order} / range_reduce "
                         f"{range_reduce} out of range")
    eb, mb = fmt_args(in_fmt)
    rows, cols = x.shape
    out = torch.empty_like(x)
    if rows == 0 or cols == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_softmax_f32(x.data_ptr(), out.data_ptr(), rows, cols,
                                int(taylor_order), int(range_reduce), eb, mb,
                                stream)
    build.check(err, "fused_softmax")
    fused_softmax.launches += 1
    return out


fused_softmax.launches = 0
