"""Architecture registry over the configs ported so far.

The decoder configs whose layers are ``global``/``local`` attention, the
RG-LRU block (RecurrentGemma) or the xLSTM blocks, each with a gated MLP
or a mixture of experts where it has one; the VLM (qwen2-vl-2b: M-RoPE,
and precomputed patch embeddings put in front of the tokens); the
encoder-decoder (whisper-tiny, served by ``models/encdec``); and BraggNN:
every architecture of the reference.
The dry-run's ``input_specs``/``input_axes`` come with the dry-run.
"""

from __future__ import annotations

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
