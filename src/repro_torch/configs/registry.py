"""Architecture registry over the configs ported so far.

The decoder configs whose layers are ``global``/``local`` attention, the
RG-LRU block (RecurrentGemma) or the xLSTM blocks, each with a gated MLP
or a mixture of experts where it has one; the VLM (qwen2-vl-2b: M-RoPE,
and precomputed patch embeddings put in front of the tokens); the
encoder-decoder (whisper-tiny, served by ``models/encdec``); and BraggNN:
every architecture of the reference.  ``input_specs``/``input_axes``
give a step's data inputs as ``meta`` tensors and their logical axes, for
the shardings of a batch.
"""

from __future__ import annotations

import torch

from repro_torch.configs import (braggnn, gemma2_27b, mixtral_8x7b,
                                 qwen2_7b, qwen2_moe_a27b, qwen2_vl_2b,
                                 qwen25_3b, recurrentgemma_9b, stablelm_3b,
                                 whisper_tiny, xlstm_1_3b)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    supports_shape

_MODULES = {                                # in the reference's order
    "recurrentgemma-9b": recurrentgemma_9b,
    "gemma2-27b": gemma2_27b,
    "qwen2-7b": qwen2_7b,
    "stablelm-3b": stablelm_3b,
    "qwen2.5-3b": qwen25_3b,
    "whisper-tiny": whisper_tiny,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "mixtral-8x7b": mixtral_8x7b,
    "xlstm-1.3b": xlstm_1_3b,
    "qwen2-vl-2b": qwen2_vl_2b,
}

ARCH_IDS = tuple(_MODULES)

#: the reference's architectures whose families are not ported yet: none
#: since qwen2-vl-2b (the registry's tests read it)
NOT_PORTED: tuple = ()


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    raise KeyError(f"unknown architecture {arch!r}; known: "
                   f"{', '.join(ARCH_IDS + ('braggnn',))}")


def get_config(arch: str) -> ModelConfig:
    if arch == "braggnn":
        return braggnn.CONFIG
    return _module(arch).CONFIG


def get_tiny(arch: str):
    if arch == "braggnn":
        return braggnn.tiny()
    return _module(arch).tiny()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, supported, reason) over the ported
    architectures."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = supports_shape(cfg, shape)
            if ok or include_skipped:
                yield arch, sname, ok, why


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors for the step function's data inputs (the
    reference's ``ShapeDtypeStruct``s).

    train:    {tokens, targets[, patches | frames]}
    prefill:  {tokens[, patches | frames]}
    decode:   {tokens (B,1), pos (B,)}   (cache specs are built separately)
    """
    b, s = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.activation_dtype)

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta((b, 1)), "pos": meta((b,))}
    out = {}
    n_text = s
    if cfg.is_encoder_decoder:
        out["frames"] = meta((b, cfg.encoder_len, cfg.d_model), act)
    elif cfg.n_patches:
        out["patches"] = meta((b, cfg.n_patches, cfg.d_model), act)
        n_text = s - cfg.n_patches
    out["tokens"] = meta((b, n_text))
    if shape.kind == "train":
        out["targets"] = meta((b, n_text))
    return out


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Logical axes matching ``input_specs`` (resolved by BindingRules)."""
    if shape.kind == "decode":
        return {"tokens": ("batch", None), "pos": ("batch",)}
    out = {"tokens": ("batch", None)}
    if cfg.is_encoder_decoder:
        out["frames"] = ("batch", None, None)
    elif cfg.n_patches:
        out["patches"] = ("batch", None, None)
    if shape.kind == "train":
        out["targets"] = ("batch", None)
    return out
