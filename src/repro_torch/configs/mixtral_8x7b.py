"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) expert_d_ff=14336 vocab=32000
[arXiv:2401.04088].  All layers use SWA (window 4096) per the assignment,
making decode state bounded: long_500k RUNS with a rolling-buffer cache.

Sharding: 8 experts < 16 model-axis shards, so experts replicate and TP
runs *inside* each expert (expert_mlp -> model, 14336/16 = 896).  kv=8
doesn't divide 16 either: attention shards over head_dim.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    seq_shard_train=True,
    microbatches=4,
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=32000,
    head_dim=128,
    attn_pattern=("local",),       # SWA everywhere
    window=4096,
    rope_theta=1e6,
    n_experts=8,
    n_experts_padded=8,
    experts_per_token=2,
    expert_d_ff=14336,
    capacity_factor=1.25,
    moe_token_chunks=32,
    norm="rmsnorm",
    act="silu",
    attn_block_size=128,  # replicated-head scores: keep blocks small
    tie_embeddings=False,
    rules_overrides=(("experts", None), ("expert_mlp", "model"),
                     ("expert_embed", "data"),  # FSDP on expert weights:
                     # 47B fp32 cannot replicate over 8-way-indivisible EP
                     ("heads", None), ("kv_heads", None),
                     ("head_dim", "model")),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="mixtral-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        vocab_size=256, head_dim=16, window=8, n_experts=4,
        n_experts_padded=4, experts_per_token=2, expert_d_ff=96,
        attn_block_size=64)
