"""qwen3-32b — dense with qk_norm [hf:Qwen/Qwen3 family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk_norm, no QKV
bias (qwen3 dropped it), head_dim=128.
Same numbers as ``repro.configs.qwen3_32b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    qkv_bias=False,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    norm="rmsnorm",
    activation="silu",
    max_seq_len=512,
)
