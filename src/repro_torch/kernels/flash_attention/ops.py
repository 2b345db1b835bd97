"""Public wrapper: GQA-aware flash attention over (B, S, H, D) tensors, the
plain version for CPU tensors, the CUDA kernel for CUDA tensors; with a
gradient when one is needed."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: keys per block of the backward's recomputed scores (fewer keys: one
#: block of them all, not one padded to this width)
BACKWARD_BLOCK = 512


def _forward(q, k, v, causal, window, logit_cap, out=None,
             with_lse=False):
    """(output in q's dtype, the fp32 output (B, S, H, D), the rows'
    log-sum-exp (B, H, S) fp32 or None)."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    if h % n_kv:
        raise ValueError(f"{h} query heads over {n_kv} kv heads")
    g = h // n_kv
    dtype = q.dtype
    on_card = q.device.type != "cpu"
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if g > 1:
        kh = kh.repeat_interleave(g, dim=1)
        vh = vh.repeat_interleave(g, dim=1)
    kw = {"causal": causal, "window": window, "logit_cap": logit_cap}
    lse = None
    if on_card:
        o32 = out if out is not None and out.dtype == torch.float32 else \
            torch.empty(q.shape, device=q.device, dtype=torch.float32)
        if with_lse:
            lse = torch.empty((b * h, s), device=q.device,
                              dtype=torch.float32)
        flash_attention(qh, kh, vh, out=o32.transpose(1, 2), lse=lse, **kw)
    else:
        res = flash_attention_ref(qh.reshape(b * h, s, d),
                                  kh.reshape(b * h, -1, d),
                                  vh.reshape(b * h, -1, d),
                                  with_lse=with_lse, **kw)
        if with_lse:
            res, lse = res
        o32 = res.reshape(b, h, s, d).transpose(1, 2)
    lse = None if lse is None else lse.view(b, h, s)
    if o32 is out:
        return out, o32, lse
    o = o32.to(dtype)
    return (o if out is None else out.copy_(o)), o32, lse


class _Attention(torch.autograd.Function):
    """K5 (or its plain version) as the forward, writing the rows'
    log-sum-exp; the backward is ``nn.attention.blockwise_grads`` at
    positions ``arange(S)``, the reference's blockwise VJP, which reads the
    original (unwidened, ungrouped) q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        o, o32, lse = _forward(q, k, v, causal, window, logit_cap,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.opts = dict(causal=causal, window=window, logit_cap=logit_cap,
                        block_size=min(BACKWARD_BLOCK, k.shape[1]))
        return o

    @staticmethod
    def backward(ctx, do):
        # nn.attention imports this module: bound at the first backward
        from repro_torch.nn.attention import blockwise_grads
        q, k, v, o32, lse = ctx.saved_tensors
        b, s, h, d = q.shape
        n_kv = k.shape[2]
        pos = torch.arange(s, device=q.device).expand(b, s)
        dq, dk, dv = blockwise_grads(
            q, k, v, pos, pos, o32.reshape(b, s, n_kv, h // n_kv, d),
            lse.view(b, n_kv, h // n_kv, s), None, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: float = 0.0,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, S, H, D), k/v: (B, S, K, D) with H % K == 0 -> (B, S, H, D)
    in q's dtype, written into ``out`` (any strides) when it is given.
    The kernel reads fp32 operands in place as (B, H, S, D) views; grouped
    KV heads (K < H) are repeated into a copy, and bf16 operands are read
    through fp32 copies (the kernel is fp32 only: the scores, softmax and
    sums are fp32 on either path).

    Where autograd needs a gradient of q, k or v, the call goes through an
    ``autograd.Function``: the same forward, which also writes each row's
    log-sum-exp, and the reference's blockwise backward.  ``out`` takes
    no gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if out is not None:
            raise ValueError("attention: out= takes no gradient")
        return _Attention.apply(q, k, v, causal, window, logit_cap)
    return _forward(q, k, v, causal, window, logit_cap, out=out)[0]
