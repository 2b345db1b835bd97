"""Public wrapper for the fused softmax: rows of any N-D input, the plain
version for a CPU tensor, the CUDA kernel for a CUDA tensor."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_softmax.fused_softmax import fused_softmax
from repro_torch.kernels.fused_softmax.ref import fused_softmax_ref


def softmax(x: torch.Tensor, *, taylor_order: int = 0,
            range_reduce: int = 2,
            in_fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    x2 = x.reshape(-1, x.shape[-1])
    kw = {"taylor_order": taylor_order, "range_reduce": range_reduce,
          "in_fmt": in_fmt}
    if x.device.type == "cpu":
        out = fused_softmax_ref(x2, **kw)
    else:
        out = fused_softmax(x2, **kw)
    return out.reshape(x.shape)
