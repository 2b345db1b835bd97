"""qwen2-7b [dense] — GQA with QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2407.10671].
Untied embeddings.  28 heads / 4 KV heads don't divide the 16-wide model
axis, so attention shards over head_dim instead (heads replicated) — see
DESIGN.md §binding.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=8,
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
    attn_block_size=256,  # replicated-head scores: keep blocks small
    tie_embeddings=False,
    rules_overrides=(("heads", None), ("kv_heads", None),
                     ("head_dim", "model")),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="qwen2-tiny", n_layers=3, d_model=64, n_heads=7, n_kv_heads=1,
        d_ff=160, vocab_size=256, head_dim=16, attn_block_size=64)
