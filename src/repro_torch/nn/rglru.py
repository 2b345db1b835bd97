"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
reference's ``repro.nn.rglru`` in torch.

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t)                      (recurrence gate)
    i_t = sigmoid(W_x x_t)                      (input gate)
    log a_t = -c * softplus(Lambda) * r_t       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A diagonal linear recurrence.  The reference lowers the prefill to
``jax.lax.associative_scan``; the port scans by recursive doubling on whole
tensors (:func:`_doubling_scan`): ⌈log2 S⌉ steps of a few element-wise
launches each, and no loop over time.  Decode is one update with O(1)
state.  Gate matrices are block-diagonal over heads, as in RecurrentGemma,
and a short causal depthwise conv (width 4) comes first.  No TPU kernel
computes any of this: it runs as PyTorch operations on the card.

A decode step writes its new state into the cache it was given, in place
(``copy_``): the engine's captured decode step holds that cache, and a
state rebound in a returned dict would not reach it.

Under tensor parallelism (:mod:`repro_torch.nn.tensor_parallel`, where the
rules split ``mlp`` and ``heads`` over ``model``) each rank computes its
block of the channels: ``in_x`` and ``in_gate`` column-parallel, the conv,
the gates and the recurrence on its own channels (its heads of the
block-diagonal gates are exactly its channels': ``launch.shardings.
model_split`` takes the split plan only then), ``out`` row-parallel, its
partial sums added over ``model``.  The decode cache then holds the rank's
channels, updated in place as above.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn.layers import matmul_f32, maybe_quantize
from repro_torch.nn.module import ParamSpec

ACCUM = torch.float32
C_RGLRU = 8.0


def rglru_block_specs(d: int, lru_width: int, n_heads: int,
                      conv_width: int = 4) -> dict:
    w = lru_width // n_heads
    return {
        "in_x": {"kernel": ParamSpec((d, lru_width), ("embed", "mlp"))},
        "in_gate": {"kernel": ParamSpec((d, lru_width), ("embed", "mlp"))},
        "conv": {"kernel": ParamSpec((conv_width, lru_width),
                                     (None, "mlp")),
                 "bias": ParamSpec((lru_width,), ("mlp",), init="zeros")},
        "gate_a": {"kernel": ParamSpec((n_heads, w, w),
                                       ("heads", None, None), scale=0.02),
                   "bias": ParamSpec((lru_width,), ("mlp",), init="zeros")},
        "gate_x": {"kernel": ParamSpec((n_heads, w, w),
                                       ("heads", None, None), scale=0.02),
                   "bias": ParamSpec((lru_width,), ("mlp",), init="zeros")},
        "lamb": ParamSpec((lru_width,), ("mlp",), init="ones"),
        "out": {"kernel": ParamSpec((lru_width, d), ("mlp", "embed"))},
    }


def _blockdiag(p: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x: (..., W) through block-diagonal (H, w, w) + bias, in fp32."""
    *lead, width = x.shape
    xh = x.reshape(*lead, n_heads, width // n_heads)
    y = torch.einsum("...hw,hwv->...hv", xh.to(ACCUM),
                     p["kernel"].to(ACCUM))
    return y.reshape(*lead, width) + p["bias"].to(ACCUM)


def _causal_conv(p: dict, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv by shifted adds (the width is small).

    x: (B, S, W).  state: (B, cw-1, W) trailing context for decode, in any
    float dtype (it joins ``x`` in ``x``'s dtype, as the reference's
    concatenation promotes it).  Returns (y, new_state).
    """
    cw = p["kernel"].shape[0]
    if state is None:
        state = torch.zeros(x.shape[0], cw - 1, x.shape[-1], dtype=x.dtype,
                            device=x.device)
    ctx = torch.cat([state.to(x.dtype), x], dim=1)      # (B, S+cw-1, W)
    s = x.shape[1]
    y = torch.zeros(x.shape, dtype=ACCUM, device=x.device)
    for j in range(cw):
        y = y + ctx[:, j:j + s, :].to(ACCUM) * p["kernel"][cw - 1 - j].to(
            ACCUM)
    y = y + p["bias"].to(ACCUM)
    new_state = ctx[:, -(cw - 1):, :] if cw > 1 else state
    return y.to(x.dtype), new_state


def _gates(p: dict, x: torch.Tensor, n_heads: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a, gated_input), both (B, S, W) in fp32."""
    r = torch.sigmoid(_blockdiag(p["gate_a"], x, n_heads))
    i = torch.sigmoid(_blockdiag(p["gate_x"], x, n_heads))
    log_a = -C_RGLRU * F.softplus(p["lamb"].to(ACCUM)) * r
    a2 = torch.exp(2.0 * log_a)
    gx = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * x.to(ACCUM))
    return log_a, gx


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t·h_{t-1} + b_t`` along axis 1 from
    ``h = 0``: (the products of ``a`` up to t, h_t).  Recursive doubling
    (Hillis-Steele): at offset o each t ≥ o takes in the pair at t - o,
    ``b_t ← a_t·b_{t-o} + b_t`` and ``a_t ← a_t·a_{t-o}``, for
    o = 1, 2, 4, ... below S."""
    o = 1
    while o < a.shape[1]:
        b = torch.cat([b[:, :o], torch.addcmul(b[:, o:], a[:, o:],
                                               b[:, :-o])], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return a, b


def rglru_scan(p: dict, x: torch.Tensor, *, n_heads: int,
               h0: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over a sequence.  x: (B, S, W) -> (y, h_last fp32)."""
    log_a, gx = _gates(p, x, n_heads)
    a_seq, h = _doubling_scan(torch.exp(log_a), gx)
    if h0 is not None:
        h = h + a_seq * h0[:, None, :].to(ACCUM)
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(p: dict, x: torch.Tensor, h: torch.Tensor, *, n_heads: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x: (B, 1, W), h: (B, W) fp32 state."""
    log_a, gx = _gates(p, x, n_heads)
    h_new = torch.exp(log_a[:, 0, :]) * h + gx[:, 0, :]
    return h_new.to(x.dtype)[:, None, :], h_new


def rglru_block(p: dict, x: torch.Tensor, *, n_heads: int,
                cache: Optional[dict] = None,
                quant: Optional[str] = None
                ) -> tuple[torch.Tensor, Optional[dict]]:
    """The Griffin recurrent temporal-mixing block (in place of attention):

    y = W_out( gelu(W_gate x) * RGLRU(conv4(W_x x)) )

    cache (decode): {"h": (B, W) fp32, "conv": (B, cw-1, W)}, written in
    place and returned; None for the prefill.  ``n_heads`` is the layer's;
    under tensor parallelism ``p``, the cache and W are the rank's block of
    the channels, and the gates run on its block of the heads.
    """
    dt = x.dtype
    heads = tp.block(n_heads, "heads")
    n_heads = heads.stop - heads.start
    x = tp.copy_to_model(x, "mlp")
    w_x = maybe_quantize(p["in_x"]["kernel"], quant).to(dt)
    w_g = maybe_quantize(p["in_gate"]["kernel"], quant).to(dt)
    xb = matmul_f32(x, w_x).to(dt)
    gb = matmul_f32(x, w_g)
    xc, new_conv = _causal_conv(p["conv"], xb,
                                cache["conv"] if cache else None)
    if cache is not None:
        y_rec, h = rglru_step(p, xc, cache["h"], n_heads=n_heads)
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
    else:
        y_rec, _ = rglru_scan(p, xc, n_heads=n_heads)
    y = F.gelu(gb, approximate="tanh").to(dt) * y_rec
    w_o = maybe_quantize(p["out"]["kernel"], quant).to(dt)
    return tp.reduce_from_model(matmul_f32(y, w_o), "mlp").to(dt), cache


def init_rglru_cache(batch: int, lru_width: int, conv_width: int = 4,
                     dtype=torch.bfloat16, device=None) -> dict:
    return {
        "h": torch.zeros(batch, lru_width, dtype=ACCUM, device=device),
        "conv": torch.zeros(batch, conv_width - 1, lru_width, dtype=dtype,
                            device=device),
    }
