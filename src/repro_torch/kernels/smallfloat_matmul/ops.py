"""Public wrappers for the smallfloat matmul: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor.  ``exp_bits=None`` skips operand
quantisation (plain fp32 matmul)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.smallfloat_matmul.ref import (
    Dense, smallfloat_matmul_chain_ref, smallfloat_matmul_ref)
from repro_torch.kernels.smallfloat_matmul.smallfloat_matmul import (
    smallfloat_matmul, smallfloat_matmul_chain)


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


def matmul_chain(x: torch.Tensor, layers: Sequence[Dense], *,
                 exp_bits: Optional[int] = 5,
                 man_bits: Optional[int] = 4) -> torch.Tensor:
    """A chain of ``Dense`` layers, each layer's result the next one's
    input: one kernel launch on a CUDA tensor."""
    kw = {"exp_bits": exp_bits, "man_bits": man_bits}
    if x.device.type == "cpu":
        return smallfloat_matmul_chain_ref(x, layers, **kw)
    return smallfloat_matmul_chain(x, layers, **kw)
