"""Attention parameter specs.

Only the spec builder the ``Attention`` graph node needs
(``nn.graph.Attention.param_specs``) lives here so far; the attention
compute comes with the transformer slice.
"""

from __future__ import annotations

from repro_torch.nn.module import ParamSpec


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
