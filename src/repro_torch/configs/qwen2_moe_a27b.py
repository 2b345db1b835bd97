"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + shared experts.

24L d_model=2048 16H (GQA kv=16) expert_d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B].  60 experts padded to 64 for EP over the
16-wide model axis (padding experts masked from routing); shared-expert
block of width 5632 (= 4 x 1408, the "4 shared" of the assignment).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    remat="full",
    microbatches=4,
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                       # all FFN compute is MoE
    vocab_size=151936,
    head_dim=128,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1e6,
    n_experts=60,
    n_experts_padded=64,
    experts_per_token=4,
    expert_d_ff=1408,
    n_shared_experts=4,
    shared_d_ff=5632,
    capacity_factor=1.25,
    moe_token_chunks=32,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=False,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        microbatches=1, name="qwen2-moe-tiny", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, vocab_size=256, head_dim=16, n_experts=6,
        n_experts_padded=8, experts_per_token=2, expert_d_ff=32,
        n_shared_experts=2, shared_d_ff=64, attn_block_size=64)
