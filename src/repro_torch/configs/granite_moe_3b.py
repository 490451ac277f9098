"""granite-moe-3b-a800m — MoE [hf:ibm-granite/granite-3.0-*-base family].

32L d_model=1536 24H (GQA kv=8) d_ff=512 (per expert) vocab=49155,
MoE 40 experts top-8 on every layer.
Same numbers as ``repro.configs.granite_moe_3b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff=512),
    norm="rmsnorm",
    activation="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=64),
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    max_seq_len=512,
)
