"""jamba-v0.1-52b — hybrid Mamba+attention MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 16e top-2, Mamba:attn 1:7
interleave. Published structure: attn_layer_period=8, attn_layer_offset=4
(layers 4, 12, 20, 28 are attention; the rest Mamba); expert_layer_period=2,
expert_layer_offset=1 (odd layers are MoE, even are dense MLP).
Same numbers as ``repro.configs.jamba_v01_52b``.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attn_period=8,
    attn_offset=4,
    moe=MoEConfig(
        num_experts=16, top_k=2, d_ff=14336, layer_period=2, layer_offset=1
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
    norm="rmsnorm",
    activation="silu",
    rope_theta=10_000.0,  # jamba attn layers carry no RoPE in v0.1; kept for ablation
    max_seq_len=262_144,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,  # one full period: attn at 4, MoE on odd layers
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    attn_period=8,
    attn_offset=4,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=128, layer_period=2, layer_offset=1),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=32),
    norm="rmsnorm",
    activation="silu",
    max_seq_len=1024,
)
