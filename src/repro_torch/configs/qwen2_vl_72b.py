"""qwen2-vl-72b — VLM backbone [arXiv:2409.12191].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, M-RoPE. The vision
frontend is a stub: input_specs() feeds precomputed patch/text embeddings
(B, S, d_model) plus 3-section M-RoPE position ids (DESIGN.md §5).
Same numbers as ``repro.configs.qwen2_vl_72b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,  # qwen2 family uses QKV bias
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w sections of head_dim//2
    activation="silu",
    norm="rmsnorm",
    input_is_embeddings=True,
    max_seq_len=32_768,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(2, 3, 3),
    activation="silu",
    norm="rmsnorm",
    input_is_embeddings=True,
    max_seq_len=512,
)
