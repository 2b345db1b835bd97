"""Attention parameter specs and the q/k/v and output projections.

``attn_specs`` is the spec builder the ``Attention`` graph node needs
(``nn.graph.Attention.param_specs``); ``qkv_project`` and ``out_project``
are the projections of the transformer block's tensor twin
(``models/transformer.py``): torch einsums at fp32 with fp32 accumulation
and an optional weight quantised to a FloPoCo format.  Rope, masks and the
decode path come with the LM substrate.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import FORMATS, quantize
from repro_torch.nn.module import ParamSpec

ACCUM = torch.float32


def attn_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
               *, qkv_bias: bool = False) -> dict:
    s = {
        "q": {"kernel": ParamSpec((d_model, n_heads, head_dim),
                                  ("embed", "heads", "head_dim"))},
        "k": {"kernel": ParamSpec((d_model, n_kv_heads, head_dim),
                                  ("embed", "kv_heads", "head_dim"))},
        "v": {"kernel": ParamSpec((d_model, n_kv_heads, head_dim),
                                  ("embed", "kv_heads", "head_dim"))},
        "o": {"kernel": ParamSpec((n_heads, head_dim, d_model),
                                  ("heads", "head_dim", "embed"))},
    }
    if qkv_bias:
        s["q"]["bias"] = ParamSpec((n_heads, head_dim),
                                   ("heads", "head_dim"), init="zeros")
        s["k"]["bias"] = ParamSpec((n_kv_heads, head_dim),
                                   ("kv_heads", "head_dim"), init="zeros")
        s["v"]["bias"] = ParamSpec((n_kv_heads, head_dim),
                                   ("kv_heads", "head_dim"), init="zeros")
    return s


def maybe_quantize(w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``w`` rounded to the FloPoCo format ``quant`` (a ``FORMATS`` key), or
    ``w`` itself for ``None``."""
    return w if quant is None else quantize(w, FORMATS[quant])


def qkv_project(p: dict, x: torch.Tensor, *, quant: Optional[str] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q, k, v: (B, S, H, dh) each (``p``: the
    :func:`attn_specs` tree)."""
    def proj(sub):
        w = maybe_quantize(sub["kernel"], quant).to(ACCUM)
        y = torch.einsum("bsd,dhk->bshk", x.to(ACCUM), w)
        if "bias" in sub:
            y = y + sub["bias"].to(ACCUM)
        return y.to(x.dtype)
    return proj(p["q"]), proj(p["k"]), proj(p["v"])


def out_project(p: dict, y: torch.Tensor, *, quant: Optional[str] = None
                ) -> torch.Tensor:
    """y: (B, S, H, dh) -> (B, S, D)."""
    w = maybe_quantize(p["o"]["kernel"], quant).to(ACCUM)
    return torch.einsum("bshk,hkd->bsd", y.to(ACCUM), w).to(y.dtype)
