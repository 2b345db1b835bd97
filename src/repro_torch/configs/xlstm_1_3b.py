"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks.

48L d_model=2048 4H d_ff=0 vocab=50304 [arXiv:2405.04517].  Pattern
xLSTM[7:1]: seven mLSTM blocks then one sLSTM block, six superblocks of
eight (48 = 6 x 8).  d_ff = 0: all FFN compute lives inside the blocks
(mLSTM projection factor 2, sLSTM gated FFN factor 4/3).  Constant-size
state: long_500k runs.

Sharding: 4 heads don't divide the 16-wide model axis — head_dim shards
(mLSTM head dim 1024 -> 64/device, sLSTM unit width 512 -> 32/device).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=8,
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attn_pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_proj_factor=2,
    mlstm_chunk=256,
    conv_width=4,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    rules_overrides=(("heads", None), ("head_dim", "model")),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="xlstm-tiny", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        vocab_size=256, attn_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        mlstm_chunk=8, attn_block_size=64)
