"""Plain PyTorch version of flash_attention (flattened-heads layout): the
whole score matrix, the reference's mask and soft-cap, then softmax; and,
for training, each row's log-sum-exp as the kernel writes it."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.3819763e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        logit_cap: float = 0.0, with_lse: bool = False):
    """q: (BH, Sq, D), k/v: (BH, Skv, D) -> (BH, Sq, D); with ``with_lse``
    also the fp32 (BH, Sq) log-sum-exp ``m + log(max(l, 1e-37))`` of each
    row's scores (``m`` 0 where the row sees no key), the kernel's."""
    d = q.shape[-1]
    # sqrt(d) rounds to the same fp32 as the reference's jnp.sqrt
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    sq, skv = q.shape[1], k.shape[1]
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None and window > 0:
        ok &= (qp - kp) < window
    s = torch.where(ok[None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, v.to(torch.float32)).to(q.dtype)
    if not with_lse:
        return out
    m = torch.amax(s, dim=-1)
    m = torch.where(m == NEG_INF, 0.0, m)
    l = torch.where(ok[None], torch.exp(s - m[..., None]), 0.0).sum(-1)
    return out, m + torch.log(torch.clamp(l, min=1e-37))
