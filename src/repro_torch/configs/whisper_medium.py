"""whisper-medium — audio encoder-decoder [arXiv:2212.04356].

24L (per stack) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. Conv
frontend is a stub: encoder input is precomputed frame embeddings
(B, S_enc, d_model); decoder consumes token ids. Whisper uses plain (non-
gated) GELU MLPs, LayerNorm, learned positions (we use sinusoidal-free
RoPE-less absolute embeddings folded into the stub; see models/encdec.py).
Assigned-shape convention (DESIGN.md §5): train/prefill use encoder frames
= decoder tokens = seq_len; decode uses decoder KV = seq_len with a fixed
1500-frame encoder context.
Same numbers as ``repro.configs.whisper_medium``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    qkv_bias=True,
    norm="layernorm",
    activation="gelu_plain",
    input_is_embeddings=True,  # encoder side
    rope_theta=10_000.0,
    max_seq_len=32_768,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    is_encoder_decoder=True,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qkv_bias=True,
    norm="layernorm",
    activation="gelu_plain",
    input_is_embeddings=True,
    max_seq_len=512,
)
