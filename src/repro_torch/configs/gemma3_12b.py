"""gemma3-12b — dense with 5:1 local:global attention [hf:google/gemma-3].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, sliding window
(1024) on local layers, 1 global layer per 6 (global_period=6), 128k
context. Gemma3 uses gated GELU and qk-norm.
Same numbers as ``repro.configs.gemma3_12b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    qk_norm=True,
    sliding_window=1024,
    global_period=6,
    norm="rmsnorm",
    activation="gelu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
    max_seq_len=131_072 * 8,  # long-context arch (runs long_500k)
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=6,  # one full 5-local + 1-global period
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    sliding_window=32,
    global_period=6,
    norm="rmsnorm",
    activation="gelu",
    tie_embeddings=True,
    scale_embeddings=True,
    max_seq_len=1024,
)
