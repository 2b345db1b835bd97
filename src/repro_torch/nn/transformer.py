"""Decoder assembly: blocks, prefill forward, cached decode step.

The reference's ``repro.nn.transformer`` in torch, for the layer kinds
``global`` and ``local`` (attention), ``rglru`` (the RG-LRU block,
:mod:`repro_torch.nn.rglru`) and ``mlstm``/``slstm`` (the xLSTM blocks,
:mod:`repro_torch.nn.xlstm`), each followed by a gated MLP or a mixture
of experts (:mod:`repro_torch.nn.moe`) where the config has one.  Layers
are grouped into *superblocks* of ``len(cfg.attn_pattern)`` layers whose
parameters are stacked (``blocks/<i>``, leading dim = superblock), with
remainder layers (n_layers mod period) in ``extra/<j>``: the reference's
tree, so its parameters and checkpoints carry straight over.  Where the
reference scans the stack with ``lax.scan``, the port loops over the
stacked index in Python.  Caches (KV, the RG-LRU's ``h``, the xLSTM cells' state, and the
conv states) mirror the parameter layout, and the decode step writes each
layer's slice of the stacked cache in place.

The VLM's patch embeddings (qwen2-vl) are normed and put in front of the
tokens.  :func:`forward` also serves training: it returns the MoE layers'
load-balancing loss beside the logits, takes each stacked leaf either as
one tensor or as a sequence of per-layer tensors (the train step's, so
each layer's gradient lands in its own slice), and with gradients on runs
each superblock layer under ``torch.utils.checkpoint`` where ``cfg.remat``
asks for it.  ``cfg.bf16_reduce`` rounds the attention out-projection's
and the MLP's ``wo`` products to bf16, as the reference does for their
cross-device sums.  Under tensor parallelism
(:mod:`repro_torch.nn.tensor_parallel`, entered by the sharded steps) the
layers compute on each rank's heads (or head-width columns), MLP columns
and vocabulary rows, and the decode cache holds the rank's KV heads or
head-width columns of the post-RoPE k and of v; the
soft-caps, norms and GeGLU are elementwise or per head and stay local, the
logits of a full-sequence forward are the rank's vocabulary columns (the
loss takes them so), and the last position's are gathered whole.
Decoder-only learned positions are not ported: a
config that asks for them raises ``NotImplementedError``.  The encoder-decoder (whisper-tiny) is not a
decoder of this module: it runs through :mod:`repro_torch.models.encdec`.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import attention, layers, module
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import tensor_parallel as tp
from repro_torch.nn import rglru, xlstm
from repro_torch.nn.module import map_tree

Params = Any

#: what the port does not run yet, and where it comes (ROADMAP.md queue 1,
#: item 8)
_LATER = "ROADMAP.md queue 1 item 8"
#: the layer kinds the port runs
_KINDS = ("global", "local", "rglru", "mlstm", "slstm")


def _check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs a part of the
    LM substrate the port has not ported yet."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: it runs through "
            f"repro_torch.models.encdec, not this decoder")
    later = [f"layer kind {k!r}" for k in dict.fromkeys(cfg.attn_pattern)
             if k not in _KINDS]
    if cfg.learned_positions:
        # no config of the repo has them: the reference's forward adds
        # them, its decode_step does not (ROADMAP.md R9)
        later.append("decoder-only learned positions (the encoder-decoder "
                     "runs through models/encdec)")
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not ported yet ({_LATER})")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def _norm_specs(cfg: ModelConfig) -> dict:
    if cfg.norm == "layernorm":
        return layers.layernorm_specs(cfg.d_model)
    return layers.rmsnorm_specs(cfg.d_model)


def _apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layers.layernorm(p, x, eps=cfg.norm_eps)
    return layers.rmsnorm(p, x, eps=cfg.norm_eps,
                          zero_centered=cfg.zero_centered_norm)


# -- one block ---------------------------------------------------------------

def mixer_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("global", "local"):
        return attention.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.resolved_head_dim,
                                    qkv_bias=cfg.qkv_bias)
    if kind == "rglru":
        return rglru.rglru_block_specs(cfg.d_model,
                                       cfg.lru_width or cfg.d_model,
                                       cfg.n_heads, cfg.conv_width)
    if kind == "mlstm":
        return xlstm.mlstm_block_specs(cfg.d_model, cfg.n_heads,
                                       proj_factor=cfg.mlstm_proj_factor,
                                       conv_width=cfg.conv_width)
    if kind == "slstm":
        return xlstm.slstm_block_specs(cfg.d_model, cfg.n_heads,
                                       conv_width=cfg.conv_width)
    raise NotImplementedError(f"layer kind {kind!r} not ported yet "
                              f"({_LATER})")


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    s: dict = {"ln1": _norm_specs(cfg), "mixer": mixer_specs(cfg, kind)}
    has_ffn = cfg.d_ff > 0 or cfg.n_experts > 0
    if has_ffn:
        s["ln2"] = _norm_specs(cfg)
        if cfg.n_experts > 0:
            s["moe"] = moe_lib.moe_specs(
                cfg.d_model, cfg.n_experts, cfg.expert_d_ff,
                n_experts_padded=cfg.n_experts_padded or cfg.n_experts,
                n_shared=cfg.n_shared_experts, shared_d_ff=cfg.shared_d_ff)
        else:
            s["mlp"] = layers.mlp_specs(cfg.d_model, cfg.d_ff, gated=True)
    if cfg.post_norms:
        s["post1"] = _norm_specs(cfg)
        if has_ffn:
            s["post2"] = _norm_specs(cfg)
    return s


def apply_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, Optional[dict],
                           Optional[torch.Tensor]]:
    """One layer: prefill or training when ``cache`` is None
    (``positions``: see :func:`attention.self_attention`), else one decode
    step at ``pos`` (B,), which writes ``cache`` in place.  Returns
    (x_out, cache, aux): ``aux`` the MoE layer's load-balancing loss, None
    for every other layer."""
    if kind not in _KINDS:
        raise NotImplementedError(f"layer kind {kind!r} not ported yet "
                                  f"({_LATER})")
    window = cfg.window if kind == "local" else None
    rdt = torch.bfloat16 if cfg.bf16_reduce else None
    attn_kw = dict(logit_cap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
                   rope_fraction=cfg.rope_fraction,
                   mrope_sections=cfg.mrope_sections or None,
                   quant=cfg.quant_format, n_kv_heads=cfg.n_kv_heads)
    aux = None
    h = _apply_norm(cfg, p["ln1"], x)
    if kind == "rglru":
        y, cache = rglru.rglru_block(p["mixer"], h, n_heads=cfg.n_heads,
                                     cache=cache, quant=cfg.quant_format)
    elif kind == "mlstm":
        y, cache = xlstm.mlstm_block(p["mixer"], h, n_heads=cfg.n_heads,
                                     chunk=cfg.mlstm_chunk, cache=cache,
                                     quant=cfg.quant_format)
    elif kind == "slstm":
        y, cache = xlstm.slstm_block(p["mixer"], h, n_heads=cfg.n_heads,
                                     cache=cache, quant=cfg.quant_format)
    elif cache is None:
        y = attention.self_attention(p["mixer"], h, positions, causal=True,
                                     window=window,
                                     block_size=cfg.attn_block_size,
                                     reduce_dtype=rdt, **attn_kw)
    else:
        y, cache = attention.decode_attention(
            p["mixer"], h, cache, pos, window=window or None, **attn_kw)
    if cfg.post_norms:
        y = _apply_norm(cfg, p["post1"], y)
    x = x + y

    if "mlp" in p or "moe" in p:
        h = _apply_norm(cfg, p["ln2"], x)
        if "moe" in p:
            y, aux = moe_lib.moe(
                p["moe"], h, n_experts=cfg.n_experts,
                top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor, act=cfg.act,
                quant=cfg.quant_format, token_chunks=cfg.moe_token_chunks)
        else:
            y = layers.mlp(p["mlp"], h, act=cfg.act, quant=cfg.quant_format,
                           reduce_dtype=rdt)
        if cfg.post_norms:
            y = _apply_norm(cfg, p["post2"], y)
        x = x + y
    return x, cache, aux


# -- cache construction ------------------------------------------------------

def _kind_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, conv_dtype: torch.dtype = torch.bfloat16
                     ) -> dict:
    if kind == "rglru":
        return rglru.init_rglru_cache(batch, cfg.lru_width or cfg.d_model,
                                      cfg.conv_width, dtype=conv_dtype,
                                      device=device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                      proj_factor=cfg.mlstm_proj_factor,
                                      conv_width=cfg.conv_width,
                                      conv_dtype=conv_dtype, device=device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                                      conv_width=cfg.conv_width,
                                      conv_dtype=conv_dtype, device=device)
    return attention.init_kv_cache(
        batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
        window=cfg.window if kind == "local" else None, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """The model's decode cache on ``device`` (default: the CPU), laid out
    as the reference's: ``blocks/<i>`` stacked over superblocks,
    ``extra/<j>`` per remainder layer.  A remainder recurrent layer's conv
    state (RG-LRU, mLSTM, sLSTM) is in the activation dtype, a stacked
    one's in bf16 (ROADMAP.md R8): the dtypes the reference's cache has
    after its first step."""
    _check_supported(cfg)
    out: dict = {"blocks": {}, "extra": {}}
    for i, kind in enumerate(cfg.attn_pattern):
        per = _kind_cache_init(cfg, kind, batch, max_len, device)
        out["blocks"][str(i)] = map_tree(
            lambda a: a.expand(cfg.n_superblocks, *a.shape).clone(), per)
    for j in range(cfg.n_remainder_layers):
        out["extra"][str(j)] = _kind_cache_init(
            cfg, cfg.attn_pattern[j], batch, max_len, device,
            conv_dtype=_dtype(cfg))
    return out


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache's stand-ins on the ``meta`` device (the reference's
    ``ShapeDtypeStruct``s), for the dry-run: :func:`init_cache` itself,
    so the shapes have one source.  Its dtypes are the ones the
    reference's cache holds after its first step (ROADMAP.md R8), where
    the reference's specs give a remainder layer's conv state in bf16."""
    return init_cache(cfg, batch, max_len, device="meta")


def _kind_cache_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of one layer's cache leaves."""
    if kind in ("global", "local"):
        kv = ("batch", None, "kv_heads", "head_dim")
        out = {"k": kv, "v": kv}
        if kind == "local" and cfg.window:
            out["kpos"] = ("batch", None)
        return out
    if kind == "rglru":
        return {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}
    if kind == "mlstm":
        return {"C": ("batch", "heads", "head_dim", None),
                "n": ("batch", "heads", "head_dim"),
                "m": ("batch", "heads"),
                "conv": ("batch", None, "mlp")}
    if kind == "slstm":
        ax = ("batch", "heads", "head_dim")
        return {"h": ax, "c": ax, "n": ax, "m": ax,
                "conv": ("batch", None, "embed")}
    raise NotImplementedError(f"layer kind {kind!r} not ported yet "
                              f"({_LATER})")


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree of :func:`init_cache`'s: ``"layers"`` in front
    of every stacked leaf."""
    out: dict = {"blocks": {}, "extra": {}}
    for i, kind in enumerate(cfg.attn_pattern):
        out["blocks"][str(i)] = map_tree(lambda a: ("layers",) + a,
                                         _kind_cache_axes(cfg, kind))
    for j in range(cfg.n_remainder_layers):
        out["extra"][str(j)] = _kind_cache_axes(cfg, cfg.attn_pattern[j])
    return out


# -- model specs -------------------------------------------------------------

def model_specs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    s: dict = {
        "embed": layers.embedding_specs(cfg.vocab_size, cfg.d_model),
        "final_norm": _norm_specs(cfg),
        "blocks": {},
        "extra": {},
    }
    for i, kind in enumerate(cfg.attn_pattern):
        s["blocks"][str(i)] = module.stack(block_specs(cfg, kind),
                                           cfg.n_superblocks)
    for j in range(cfg.n_remainder_layers):
        s["extra"][str(j)] = block_specs(cfg, cfg.attn_pattern[j])
    if not cfg.tie_embeddings:
        s["unembed"] = {"kernel": module.ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))}
    if cfg.n_patches:
        s["patch_norm"] = _norm_specs(cfg)
    return s


# -- forward (prefill) and decode --------------------------------------------

def _layers(cfg: ModelConfig, params: Params, cache: Optional[dict] = None):
    """Each layer in order as (kind, params, cache, stacked): views into
    the stacked trees, so a decode step's cache writes land in the stack
    (a stacked leaf may also be a sequence of per-layer tensors, which
    ``a[li]`` indexes alike); ``stacked`` is False for a remainder
    layer."""
    for li in range(cfg.n_superblocks):
        for i, kind in enumerate(cfg.attn_pattern):
            at = (lambda a, li=li: a[li])
            yield (kind, map_tree(at, params["blocks"][str(i)]),
                   None if cache is None
                   else map_tree(at, cache["blocks"][str(i)]), True)
    for j in range(cfg.n_remainder_layers):
        yield (cfg.attn_pattern[j], params["extra"][str(j)],
               None if cache is None else cache["extra"][str(j)], False)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    dt = _dtype(cfg)
    x = layers.embed(params["embed"], tokens, dtype=dt)
    if cfg.embed_scale:
        # the reference's fp32 sqrt, rounded to the activation dtype
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(dt)
    return x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x, quant=cfg.quant_format)
    else:
        logits = layers.dense(params["unembed"], x, quant=cfg.quant_format,
                              out_axis="vocab")
    return layers.softcap(logits.to(torch.float32), cfg.final_softcap)


def _remat_context(cfg: ModelConfig):
    """``torch.utils.checkpoint``'s ``context_fn`` for ``cfg.remat``: the
    reference's ``nothing_saveable`` for "full", its
    ``dots_with_no_batch_dims_saveable`` for "dots": the outputs of plain
    matrix products are kept, everything else recomputed."""
    if cfg.remat != "dots":
        return ckpt.noop_context_fn

    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


#: the products "dots" keeps: matrix products with no batch dimension
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.mm.dtype,
                   torch.ops.aten.addmm.default})


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None,
            last_logit_only: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (fp32 logits (B, S, vocab), or (B, 1, vocab)
    with ``last_logit_only``; the fp32 sum of the MoE layers'
    load-balancing losses).

    tokens: (B, S) integer ids.  patches: (B, P, d) precomputed frontend
    embeddings (the VLM's stub), cast to the activation dtype, normed with
    ``patch_norm`` and put in front of the tokens; the logits then cover
    P + S positions.  ``positions=None`` is ``arange`` over them, which
    every attention layer serves with the flash kernel on the card.  With
    gradients on and ``cfg.remat`` not "none", each superblock layer runs
    under ``torch.utils.checkpoint`` (non-reentrant), the reference's
    ``_maybe_remat``; remainder layers do not, as there.  Under
    tensor parallelism the full-sequence logits are this rank's vocabulary
    columns, the last position's (``last_logit_only``) the whole
    vocabulary.
    """
    _check_supported(cfg)
    x = _embed(cfg, params, tokens)
    if patches is not None:
        pt = patches.to(x.dtype)
        if "patch_norm" in params:
            pt = _apply_norm(cfg, params["patch_norm"], pt)
        x = torch.cat([pt, x], dim=1)
    # the reference pins the activations' batch (and sequence) sharding
    # here and after every layer (its _pin_batch, a GSPMD constraint);
    # the port's sharded step runs each rank's own rows on local tensors,
    # so there is nothing to pin
    aux = None
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for kind, p, _, stacked in _layers(cfg, params):
        if remat and stacked:
            x, _, a = ckpt.checkpoint(
                apply_block, cfg, kind, p, x, positions, use_reentrant=False,
                preserve_rng_state=False, context_fn=_remat_context(cfg))
        else:
            x, _, a = apply_block(cfg, kind, p, x, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    if last_logit_only:
        x = x[:, -1:, :]
    logits = _logits(cfg, params, x)
    if last_logit_only:
        logits = tp.gather(logits, "vocab")
    return logits, logits.new_zeros(()) if aux is None else aux


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: dict, pos: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence.  tokens (B,1); pos (B,) current index.

    Returns (logits (B, vocab), cache), the cache written in place.
    """
    x = _embed(cfg, params, tokens)
    for kind, p, c, _ in _layers(cfg, params, cache):
        x, _, _ = apply_block(cfg, kind, p, x, cache=c, pos=pos)
    return tp.gather(_logits(cfg, params, x)[:, 0, :], "vocab"), cache
