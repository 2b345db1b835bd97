"""Configuration schema: architectures and input shapes.

A copy of the reference's plain dataclasses (``repro.configs.base``).
Every architecture is a ``ModelConfig``; every workload cell is a
(ModelConfig, ShapeConfig) pair.  ``tiny()`` derives a reduced same-family
config for CPU tests; the full configs are allocated on the card
(``chip_smoke.py`` phase ``lm`` serves Qwen2.5-3B at its full width).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # temporal-mixing pattern, cycled over layers
    attn_pattern: tuple = ("global",)
    window: int = 0                # local/SWA window (0 = none)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    mrope_sections: tuple = ()
    # MoE
    n_experts: int = 0
    n_experts_padded: int = 0      # padded to mesh divisibility (EP)
    experts_per_token: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_token_chunks: int = 1
    # recurrent (RG-LRU / xLSTM)
    lru_width: int = 0
    conv_width: int = 4
    mlstm_proj_factor: int = 2
    mlstm_chunk: int = 256
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500
    learned_positions: bool = False
    max_position: int = 0
    # VLM (qwen2-vl)
    n_patches: int = 0
    # norms / activations
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    zero_centered_norm: bool = False
    post_norms: bool = False       # gemma2 sandwich norms
    act: str = "silu"
    tie_embeddings: bool = True
    embed_scale: bool = False
    # execution
    activation_dtype: str = "bfloat16"
    quant_format: Optional[str] = None   # paper (wE,wF) weight quantisation
    remat: str = "none"                  # none | full | dots
    attn_block_size: int = 1024          # blockwise attention block
    scan_layers: bool = True
    microbatches: int = 1                # grad-accumulation microbatches
    # sharding rule overrides: tuple of (logical_axis, mesh_axes)
    rules_overrides: tuple = ()
    # mesh axes the batch dim of activations is pinned to (set by the
    # launcher per cell; empty = no explicit constraint).  GSPMD sometimes
    # loses batch sharding through blockwise-attention reshapes and
    # replicates multi-GB score tensors (measured on mixtral train_4k).
    batch_mesh_axes: tuple = ()
    # sequence-parallel activation sharding (Korthikanti-style): pin the
    # seq dim of the residual stream to these axes during train/prefill —
    # shrinks the remat stash model_axis-fold.  Opt-in via seq_shard_train;
    # the launcher fills seq_mesh_axes per cell.
    seq_shard_train: bool = False
    seq_mesh_axes: tuple = ()
    # perf knobs (hillclimb levers; see EXPERIMENTS.md §Perf)
    bf16_reduce: bool = False     # cross-device partial sums in bf16
    serve_dtype: str = ""         # cast params for decode/prefill cells

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.attn_pattern)

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // self.pattern_period

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers % self.pattern_period

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state is bounded (window/recurrent only) —
        the long_500k eligibility rule."""
        bounded = {"local", "rglru", "mlstm", "slstm"}
        kinds = set(self.attn_pattern)
        if not kinds <= bounded:
            return False
        return all(k != "local" or self.window > 0 for k in kinds)

    def layer_kind(self, i: int) -> str:
        return self.attn_pattern[i % self.pattern_period]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not).  Encodes the skip rules of the brief."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention layers present: 500k decode cache is "
                       "not sub-quadratic (skip per brief, see DESIGN.md)")
    if cfg.is_encoder_decoder and shape.kind == "decode" \
            and shape.name == "long_500k":
        return False, "encoder-decoder: no 500k decoder context"
    return True, ""
