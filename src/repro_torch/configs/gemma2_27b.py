"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118].  Sandwich (pre+post) norms, zero-centred RMSNorm,
GeGLU, attn softcap 50, final softcap 30, window 4096 on local layers.
long_500k skipped: global layers are full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=16,
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    attn_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    norm="rmsnorm",
    zero_centered_norm=True,
    post_norms=True,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="gemma2-tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=256, head_dim=16, window=8, attn_block_size=64)
