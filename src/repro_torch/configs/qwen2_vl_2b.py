"""qwen2-vl-2b [vlm] — M-RoPE, dynamic-resolution vision (frontend stubbed).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2409.12191].
Per the brief the vision frontend is a STUB: ``input_specs`` provides 1024
precomputed patch embeddings (B, 1024, 1536) which are prepended to the
token stream; M-RoPE rotates (t, h, w) position streams over frequency
sections (16, 24, 24) of the 128-wide head dim.  12 heads / 2 kv heads
don't divide 16: head_dim sharding.  long_500k: skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=4,
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    n_patches=1024,
    norm="rmsnorm",
    act="silu",
    attn_block_size=256,  # replicated-head scores: keep blocks small
    tie_embeddings=True,
    rules_overrides=(("heads", None), ("kv_heads", None),
                     ("head_dim", "model")),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="qwen2-vl-tiny", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, head_dim=16,
        mrope_sections=(4, 2, 2), n_patches=4, attn_block_size=64)
