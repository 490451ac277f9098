"""granite-moe-1b-a400m — MoE [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 32 experts top-8 on every layer.
Same numbers as ``repro.configs.granite_moe_1b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
    norm="rmsnorm",
    activation="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-1b-smoke",
    family="moe",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=128,
    head_dim=12,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=32),
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    max_seq_len=256,
)
