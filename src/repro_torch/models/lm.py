"""Causal language model: loss, the serving prefill and the cached serve
step.

``train_loss`` is the objective the train step (``launch/steps.py``)
differentiates; ``prefill`` is the prefill workload: a full-sequence
forward that returns the logits of the last position (the serving prefill
contract), the VLM's patches in front of the tokens; ``serve_step`` (one
token, cached) is what the decode loop runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import module as module_lib
from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn import transformer


#: MoE load-balance loss weight
AUX_WEIGHT = 0.01


def train_loss(cfg: ModelConfig, params, batch: dict
               ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy.  batch: {tokens, targets[, patches]}
    (tensors; targets < 0 are not counted).  The VLM's patch positions
    are dropped before the loss.

    Returns (loss + ``AUX_WEIGHT`` x the MoE aux loss, {"loss",
    "aux_loss", "tokens"}), fp32 scalars.
    """
    logits, aux = transformer.forward(cfg, params, batch["tokens"],
                                      patches=batch.get("patches"))
    targets = batch["targets"]
    if logits.shape[1] != targets.shape[1]:      # VLM: drop patch positions
        logits = logits[:, -targets.shape[1]:, :]
    loss, tokens = next_token_loss(logits, targets)
    total = loss + AUX_WEIGHT * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": tokens}


def next_token_loss(logits: torch.Tensor, targets: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean cross-entropy of ``logits`` (B, S, V) at ``targets`` (B, S)
    over the targets >= 0, their count), fp32.  Under tensor parallelism
    ``logits`` are this rank's vocabulary columns (``tp.cross_entropy``
    combines the ranks' log-sum-exps), so the whole vocabulary's logits
    never exist."""
    targets = targets.long()
    # -log softmax at each target (a target < 0 reads class 0, then counts
    # 0); the gradient writes each element once, where a gather's backward
    # would add with atomics
    nll = tp.cross_entropy(
        logits.to(torch.float32).reshape(-1, logits.shape[-1]),
        targets.clamp(min=0).reshape(-1)).reshape(targets.shape)
    mask = (targets >= 0).to(torch.float32)
    count = torch.sum(mask)
    return torch.sum(nll * mask) / torch.clamp(count, min=1.0), count


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill workload: fp32 logits at the final position, (B, vocab);
    ``patches`` (B, P, d), the VLM's, go in front of the tokens.

    Only the last position is unembedded — (B, S, vocab) logits would cost
    GBs and S x the unembed FLOPs for values that are thrown away.
    """
    logits, _ = transformer.forward(cfg, params, tokens, patches=patches,
                                    last_logit_only=True)
    return logits[:, -1, :]


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
