"""stablelm-3b [dense] — MHA, LayerNorm, partial rotary embeddings.

32L d_model=2560 32H (kv=32, full MHA) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b family].  Rotary fraction 0.25.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=4,
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    attn_pattern=("global",),
    rope_theta=10000.0,
    rope_fraction=0.25,
    norm="layernorm",
    norm_eps=1e-5,
    act="silu",
    tie_embeddings=False,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="stablelm-tiny", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        attn_block_size=64)
