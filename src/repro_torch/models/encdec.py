"""Encoder-decoder backbone (whisper-tiny): the reference's
``repro.models.encdec`` in torch.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, d_model).  The encoder is a
bidirectional transformer over the frames with learned positions; the
decoder is a causal transformer with learned positions and
cross-attention into the encoder's output.  Both self-attentions of the
prefill run at positions ``arange(S)`` (``positions=None``), which the
flash-attention kernel (K5) serves on the card: the encoder's non-causal
at S = 1,500 for whisper-tiny, the teacher-forced decoder's causal.  The
cached step attends to its KV cache, and every step to the encoder's
output, with the materialised scores, as the reference does.

``serve_step`` writes the self-attention cache in place; on the card it is
replayed from one captured CUDA graph per batch shape
(:func:`step_runner`, the counterpart of the reference's ``jax.jit``).
``train_loss`` is the teacher-forced cross-entropy the train step
(``launch/steps.py``) differentiates; K5's gradient runs through the
reference's blockwise backward.  As in the reference, neither stack is
rematerialised.  A stacked leaf (``encoder``, ``decoder``) may also be a
sequence of per-layer tensors, which ``a[li]`` indexes alike: the train
step's leaves.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import GraphRunner
from repro_torch.models.lm import next_token_loss
from repro_torch.nn import attention, layers, module
from repro_torch.nn.module import map_tree


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.layernorm_specs(cfg.d_model),
        "attn": attention.attn_specs(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.resolved_head_dim),
        "ln2": layers.layernorm_specs(cfg.d_model),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff, gated=False),
    }


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": layers.layernorm_specs(cfg.d_model),
        "self_attn": attention.attn_specs(cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads,
                                          cfg.resolved_head_dim),
        "ln_cross": layers.layernorm_specs(cfg.d_model),
        "cross_attn": attention.attn_specs(cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads,
                                           cfg.resolved_head_dim),
        "ln2": layers.layernorm_specs(cfg.d_model),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff, gated=False),
    }


def model_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": layers.embedding_specs(cfg.vocab_size, cfg.d_model),
        "enc_pos": {"table": module.ParamSpec(
            (cfg.encoder_len, cfg.d_model), (None, "embed"), scale=0.02)},
        "dec_pos": {"table": module.ParamSpec(
            (cfg.max_position, cfg.d_model), (None, "embed"), scale=0.02)},
        "encoder": module.stack(_enc_layer_specs(cfg), cfg.n_encoder_layers),
        "decoder": module.stack(_dec_layer_specs(cfg), cfg.n_layers),
        "enc_norm": layers.layernorm_specs(cfg.d_model),
        "dec_norm": layers.layernorm_specs(cfg.d_model),
    }


def _positions(params: dict, name: str, at: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """Rows ``at`` of a learned position table (clamped to its last row),
    in ``dt``."""
    table = params[name]["table"]
    return table[torch.clamp(at, max=table.shape[0] - 1)].to(dt)


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, d) stubbed frontend embeddings -> the encoder's
    output (B, T_enc, d) in the activation dtype."""
    dt = _dtype(cfg)
    x = frames.to(dt)
    x = x + _positions(params, "enc_pos",
                       torch.arange(x.shape[1], device=x.device), dt)
    for li in range(cfg.n_encoder_layers):
        p = map_tree(lambda a: a[li], params["encoder"])
        h = layers.layernorm(p["ln1"], x, eps=cfg.norm_eps)
        x = x + attention.self_attention(
            p["attn"], h, None, n_kv_heads=cfg.n_kv_heads, causal=False,
            rope_theta=cfg.rope_theta, quant=cfg.quant_format)
        h = layers.layernorm(p["ln2"], x, eps=cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, act="gelu", quant=cfg.quant_format)
    return layers.layernorm(params["enc_norm"], x, eps=cfg.norm_eps)


def _dec_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
               enc: torch.Tensor, cache: Optional[dict] = None,
               pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder layer: the prefill's causal self-attention at
    ``arange(S)`` when ``cache`` is None, else one step at ``pos`` (B,)
    that writes ``cache`` in place."""
    h = layers.layernorm(p["ln1"], x, eps=cfg.norm_eps)
    if cache is None:
        y = attention.self_attention(
            p["self_attn"], h, None, n_kv_heads=cfg.n_kv_heads, causal=True,
            rope_theta=cfg.rope_theta, quant=cfg.quant_format)
    else:
        y, _ = attention.decode_attention(
            p["self_attn"], h, cache, pos, n_kv_heads=cfg.n_kv_heads,
            rope_theta=cfg.rope_theta, quant=cfg.quant_format)
    x = x + y
    h = layers.layernorm(p["ln_cross"], x, eps=cfg.norm_eps)
    x = x + attention.cross_attention(p["cross_attn"], h, enc,
                                      n_kv_heads=cfg.n_kv_heads,
                                      quant=cfg.quant_format)
    h = layers.layernorm(p["ln2"], x, eps=cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h, act="gelu", quant=cfg.quant_format)


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = layers.layernorm(params["dec_norm"], x, eps=cfg.norm_eps)
    return layers.unembed(params["embed"], x, quant=cfg.quant_format)


def decode_forward(cfg: ModelConfig, params, tokens: torch.Tensor,
                   enc: torch.Tensor, last_logit_only: bool = False
                   ) -> torch.Tensor:
    """Teacher-forced decoder forward: fp32 logits (B, S, vocab), or
    (B, 1, vocab) with ``last_logit_only``."""
    dt = _dtype(cfg)
    x = layers.embed(params["embed"], tokens, dtype=dt)
    x = x + _positions(params, "dec_pos",
                       torch.arange(tokens.shape[1], device=x.device), dt)
    for li in range(cfg.n_layers):
        x = _dec_layer(cfg, map_tree(lambda a: a[li], params["decoder"]), x,
                       enc)
    if last_logit_only:
        x = x[:, -1:, :]
    return _logits(cfg, params, x)


def train_loss(cfg: ModelConfig, params, batch: dict
               ) -> tuple[torch.Tensor, dict]:
    """batch: {frames (B, T, d), tokens (B, S), targets (B, S)} ->
    (next-token cross-entropy over targets >= 0, {"loss"})."""
    enc = encode(cfg, params, batch["frames"])
    logits = decode_forward(cfg, params, batch["tokens"], enc)
    loss, _ = next_token_loss(logits, batch["targets"])
    return loss, {"loss": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc: Optional[torch.Tensor] = None, device=None) -> dict:
    """{"self": the decoder's KV caches stacked over its layers (bf16),
    "enc": the encoder's output the steps attend to (zeros unless
    given)}, on ``enc``'s device or ``device``."""
    if enc is not None:
        device = enc.device
    per = attention.init_kv_cache(batch, max_len, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, device=device)
    if enc is None:
        enc = torch.zeros(batch, cfg.encoder_len, cfg.d_model,
                          dtype=_dtype(cfg), device=device)
    return {"self": map_tree(
        lambda a: a.expand(cfg.n_layers, *a.shape).clone(), per),
        "enc": enc}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """:func:`init_cache`'s stand-ins on the ``meta`` device, for the
    dry-run."""
    return init_cache(cfg, batch, max_len, device="meta")


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree of :func:`cache_specs`."""
    kv = ("layers", "batch", None, "kv_heads", "head_dim")
    return {"self": {"k": kv, "v": kv}, "enc": ("batch", None, None)}


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache: dict,
                pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step against the encoder output held in the cache.
    tokens (B, 1); pos (B,).  Returns (fp32 logits (B, vocab), cache), the
    self-attention cache written in place."""
    dt = _dtype(cfg)
    x = layers.embed(params["embed"], tokens, dtype=dt)
    x = x + _positions(params, "dec_pos", pos[:, None], dt)
    for li in range(cfg.n_layers):
        at = (lambda a, li=li: a[li])
        x = _dec_layer(cfg, map_tree(at, params["decoder"]), x, cache["enc"],
                       cache=map_tree(at, cache["self"]), pos=pos)
    return _logits(cfg, params, x)[:, 0, :], cache


def serve_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache: dict,
               pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One greedy step: (next token (B,) int32, cache written in place)."""
    logits, cache = decode_step(cfg, params, tokens, cache, pos)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def step_runner(cfg: ModelConfig, params, cache: dict) -> GraphRunner:
    """:func:`serve_step` on ``cache`` behind a :class:`GraphRunner`: feeds
    ``{"tokens": (B, 1), "pos": (B,)}`` -> the next tokens (B,) int32,
    replayed from one captured graph per batch shape on the card (its
    output is the graph's, overwritten by the next replay), eager on the
    CPU."""
    return GraphRunner(lambda f: serve_step(cfg, params, f["tokens"], cache,
                                            f["pos"])[0],
                       cache["enc"].device)


def generate(cfg: ModelConfig, params, frames: torch.Tensor,
             prompt: torch.Tensor, new_tokens: int) -> torch.Tensor:
    """Greedy decoding: encode ``frames``, feed ``prompt`` (B, P) token by
    token through :func:`step_runner`, then ``new_tokens`` greedy tokens
    (B, new_tokens) int32."""
    b, n = prompt.shape
    cache = init_cache(cfg, b, n + new_tokens,
                       enc=encode(cfg, params, frames))
    step = step_runner(cfg, params, cache)
    tok, out = prompt[:, :1], []
    for t in range(n + new_tokens - 1):
        nxt = step({"tokens": tok,
                    "pos": torch.full((b,), t, device=prompt.device)})
        if t + 1 < n:
            tok = prompt[:, t + 1:t + 2]
        else:
            out.append(nxt.clone())
            tok = out[-1][:, None].to(prompt.dtype)
    step.release()
    return torch.stack(out, 1)
