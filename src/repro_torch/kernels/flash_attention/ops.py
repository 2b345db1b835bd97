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
              logit_cap: float = 0.0,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, S, H, D), k/v: (B, S, K, D) with H % K == 0 -> (B, S, H, D)
    in q's dtype, written into ``out`` (any strides) when it is given.
    The kernel reads fp32 operands in place as (B, H, S, D) views; grouped
    KV heads (K < H) are repeated into a copy, and bf16 operands are read
    through fp32 copies (the kernel is fp32 only: the scores, softmax and
    sums are fp32 on either path)."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    if h % n_kv:
        raise ValueError(f"{h} query heads over {n_kv} kv heads")
    g = h // n_kv
    dtype = q.dtype
    on_card = q.device.type != "cpu"
    if on_card:
        q, k, v = (t.to(torch.float32) for t in (q, k, v))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if g > 1:
        kh = kh.repeat_interleave(g, dim=1)
        vh = vh.repeat_interleave(g, dim=1)
    kw = {"causal": causal, "window": window, "logit_cap": logit_cap}
    if on_card:
        o = out if out is not None and out.dtype == torch.float32 else \
            torch.empty(q.shape, device=q.device, dtype=torch.float32)
        flash_attention(qh, kh, vh, out=o.transpose(1, 2), **kw)
        if o is out:
            return out
        o = o.to(dtype)
        return o if out is None else out.copy_(o)
    of = flash_attention_ref(qh.reshape(b * h, s, d),
                             kh.reshape(b * h, -1, d),
                             vh.reshape(b * h, -1, d), **kw)
    of = of.reshape(b, h, s, d).transpose(1, 2)
    return of if out is None else out.copy_(of)
