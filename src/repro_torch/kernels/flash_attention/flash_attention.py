"""Launch wrapper for the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Online-softmax attention over (BH, S, D) fp32 with heads pre-flattened
into BH, scale 1/sqrt(D), optionally causal, windowed and soft-capped —
the reference ``flash_attention``'s contract, any S.
``flash_attention.launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import require, same_device

#: head dimensions the kernel is instantiated for
HEAD_DIMS = (8, 16, 32, 64)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q: (BH, Sq, D), k/v: (BH, Skv, D), contiguous fp32 on one CUDA
    device -> (BH, Sq, D)."""
    require(q, "q", ndim=3)
    require(k, "k", ndim=3)
    require(v, "v", ndim=3)
    same_device(q, k, v)
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
        k.shape[1], d, int(causal), int(window or 0), float(logit_cap),
        stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
