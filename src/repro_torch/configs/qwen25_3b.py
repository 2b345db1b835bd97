"""qwen2.5-3b [dense] — GQA with QKV bias, tied embeddings.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936
[hf:Qwen/Qwen2.5 family].  kv=2 doesn't divide the model axis: attention
shards over head_dim (see DESIGN.md §binding).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=4,
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    head_dim=128,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
    attn_block_size=256,  # replicated-head scores: keep blocks small
    tie_embeddings=True,
    rules_overrides=(("heads", None), ("kv_heads", None),
                     ("head_dim", "model")),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="qwen25-tiny", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=256, head_dim=16, attn_block_size=64)
