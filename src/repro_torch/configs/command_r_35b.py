"""command-r-35b — dense [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, no-bias.
Command-R ties embeddings and uses a large vocab.
Same numbers as ``repro.configs.command_r_35b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    qkv_bias=False,
    norm="layernorm",  # command-r uses LayerNorm (no bias)
    activation="silu",
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    norm="layernorm",
    activation="silu",
    tie_embeddings=True,
    max_seq_len=512,
)
