"""whisper-tiny [audio] — encoder-decoder backbone, conv frontend stubbed.

4L (enc) + 4L (dec), d_model=384 6H (kv=6) d_ff=1536 vocab=51865
[arXiv:2212.04356].  Per the brief, the audio frontend is a STUB:
``input_specs`` provides precomputed frame embeddings (B, 1500, 384).
Decoder positions are learned; the table is sized 4096 and clamped for the
synthetic 32k decode shapes (whisper's trained max is 448 — these cells are
shape exercises; noted in DESIGN.md).  vocab 51865 is padded to 51872
(+7 dead tokens) for 16-way vocab sharding — standard practice.  6 heads
don't divide 16: head_dim sharding.  long_500k: skipped (enc-dec).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=8,
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51872,  # 51865 padded +7 for 16-way vocab sharding
    head_dim=64,
    attn_pattern=("global",),
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_len=1500,
    learned_positions=True,
    max_position=4096,
    norm="layernorm",
    norm_eps=1e-5,
    act="gelu",
    tie_embeddings=True,
    attn_block_size=256,
    rules_overrides=(("heads", None), ("kv_heads", None),
                     ("head_dim", "model")),
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="whisper-micro", n_layers=2, n_encoder_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        encoder_len=24, max_position=64, attn_block_size=64)
