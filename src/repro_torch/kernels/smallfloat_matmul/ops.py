"""Public wrapper for the smallfloat matmul: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor.  ``exp_bits=None`` skips operand
quantisation (plain fp32 matmul)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.smallfloat_matmul.ref import smallfloat_matmul_ref
from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import \
    smallfloat_matmul


def matmul(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           exp_bits: Optional[int] = 5, man_bits: Optional[int] = 4,
           fuse_relu: bool = False,
           out_fmt: Optional[tuple[int, int]] = None) -> torch.Tensor:
    kw = {"exp_bits": exp_bits, "man_bits": man_bits, "fuse_relu": fuse_relu,
          "out_fmt": out_fmt}
    if x.device.type == "cpu":
        return smallfloat_matmul_ref(x, w, b, **kw)
    return smallfloat_matmul(x, w, b, **kw)
