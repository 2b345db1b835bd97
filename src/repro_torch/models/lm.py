"""Causal language model: the serving prefill and the cached serve step.

``prefill`` is the prefill workload: a full-sequence forward that returns
the logits of the last position (the serving prefill contract);
``serve_step`` (one token, cached) is what the decode loop runs.  The
training loss comes with the LM's training slice (ROADMAP.md queue 1
item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import module as module_lib
from repro_torch.nn import transformer


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill workload: fp32 logits at the final position, (B, vocab).

    Only the last position is unembedded — (B, S, vocab) logits would cost
    GBs and S x the unembed FLOPs for values that are thrown away.
    """
    return transformer.forward(cfg, params, tokens,
                               last_logit_only=True)[:, -1, :]


def serve_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step: greedy next token + the cache, written in place.

    tokens: (B, 1) current token; pos: (B,) its position index.
    Returns (next_token (B,) int32, cache).
    """
    logits, cache = transformer.decode_step(cfg, params, tokens, cache, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def model_flops_per_token(cfg: ModelConfig) -> float:
    """MODEL_FLOPS = 6·N (dense, the RG-LRU hybrid, xLSTM) or 6·N_active
    (MoE) per token (§Roofline): an MoE counts its non-expert parameters
    fully and each routed expert's at ``experts_per_token`` of the padded
    experts."""
    specs = transformer.model_specs(cfg)
    if cfg.n_experts == 0:
        return 6.0 * module_lib.param_count(specs)
    e = cfg.n_experts_padded or cfg.n_experts

    def active(tree, routed=False) -> int:
        if isinstance(tree, module_lib.ParamSpec):
            size = int(np.prod(tree.shape))
            return size // e * cfg.experts_per_token if routed else size
        return sum(active(v, routed or k == "experts")
                   for k, v in tree.items())
    return 6.0 * active(specs)
