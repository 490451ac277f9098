"""mamba2-2.7b — attention-free SSM (SSD) [arXiv:2405.21060].

64L d_model=2560, d_inner = 2*d_model = 5120, headdim=64 (80 SSM heads),
d_state=128, vocab=50280. Pure Mamba2 blocks (no attention, no FFN).
Same numbers as ``repro.configs.mamba2_2_7b``.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    max_seq_len=1_048_576,  # O(1)-state decode: runs long_500k
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=32),
    norm="rmsnorm",
    activation="silu",
    tie_embeddings=True,
    max_seq_len=1024,
)
