"""Public wrapper: GQA-aware flash attention over (B, S, H, D) tensors, the
plain version for CPU tensors, the CUDA kernel for CUDA tensors."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, D), k/v: (B, S, K, D) with H % K == 0."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    if h % n_kv:
        raise ValueError(f"{h} query heads over {n_kv} kv heads")
    g = h // n_kv
    qf = q.transpose(1, 2).reshape(b * h, s, d).contiguous()
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(
        b * h, -1, d).contiguous()
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(
        b * h, -1, d).contiguous()
    fn = flash_attention_ref if q.device.type == "cpu" else flash_attention
    of = fn(qf, kf, vf, causal=causal, window=window, logit_cap=logit_cap)
    return of.reshape(b, h, s, d).transpose(1, 2)
