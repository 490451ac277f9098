"""qwen2-1.5b — dense [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, QKV bias,
tied embeddings. Same numbers as ``repro.configs.qwen2_1_5b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    head_dim=12,
    qkv_bias=True,
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    max_seq_len=512,
)
