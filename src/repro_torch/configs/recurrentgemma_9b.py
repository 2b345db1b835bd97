"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000
[arXiv:2402.19427].  Pattern (rec, rec, attn) x 12 + 2 remainder recurrent
layers (38 = 12*3 + 2).  Local attention window 2048.  Sub-quadratic:
long_500k runs (recurrent state + bounded window).

Sharding notes: MQA kv=1 cannot shard over the 16-wide model axis — KV
projections/cache replicate (kv_heads -> None); q heads shard normally.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=8,
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    attn_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    rope_theta=10000.0,
    norm="rmsnorm",
    zero_centered_norm=True,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
    rules_overrides=(("kv_heads", None),),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="recurrentgemma-tiny", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=16, lru_width=64,
        window=8, attn_block_size=64)
