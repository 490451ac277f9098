"""Model configuration schema of the port: the fields of
``repro.configs.base.ModelConfig`` that the model zoo reads.

Every family of the JAX package is ported: the dense decoder
(sliding-window attention with gemma3's 1-global-in-``global_period``
pattern, logit soft-capping, QK norm, scaled embeddings, an untied head,
layer norm, the gated SiLU / GELU and the plain-GELU MLP, query-chunked
attention), the MoE family (granite-moe: ``MoEConfig``), the SSM family
(mamba2: ``SSMConfig``, chunked SSD), the hybrid (jamba: attention at
``i % attn_period == attn_offset``, Mamba2 elsewhere, MoE on the layers
``MoEConfig.layer_period`` / ``layer_offset`` pick), the encoder-decoder
(whisper, family ``audio``: ``is_encoder_decoder`` with
``encoder_layers``) and the vlm backbone (qwen2-vl: M-RoPE through
``mrope_sections``, embedding inputs through ``input_is_embeddings``).
``validate`` makes the JAX package's checks, raised as errors, and
refuses ``moe_local_groups``, which needs a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert FFN width
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # every `period` layers, layers at `offset` (mod period) are MoE
    layer_period: int = 1
    layer_offset: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE
    sliding_window: Optional[int] = None  # local-attention window
    global_period: Optional[int] = None  # gemma3: 1 global per N layers
    attn_logit_softcap: Optional[float] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu (gated) | gelu (gated) | gelu_plain
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: x *= sqrt(d_model)
    input_is_embeddings: bool = False  # vlm / audio feed embeddings
    # hybrid (jamba): attention layer at i % attn_period == attn_offset
    attn_period: int = 1
    attn_offset: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_seq_len: int = 131_072
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # query-chunked attention from this many tokens (a multiple of the chunk)
    attn_chunk_q: int = 512
    attn_chunk_threshold: int = 4096
    # the JAX package's sequence-folded MoE dispatch under a model axis:
    # it needs a mesh, which the port has not, so a config that sets it
    # is refused
    moe_local_groups: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def validate(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        if self.family in ("moe", "hybrid") and self.moe is None:
            raise ValueError(f"{self.name}: the {self.family} family needs "
                             "moe=")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: the {self.family} family needs "
                             "ssm=")
        if self.is_encoder_decoder and self.encoder_layers <= 0:
            raise ValueError(f"{self.name}: is_encoder_decoder needs "
                             "encoder_layers > 0")
        if self.moe_local_groups:
            raise NotImplementedError(
                f"{self.name}: moe_local_groups asks for the "
                "sequence-folded MoE dispatch of a mesh, not ported yet")
        if self.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.activation not in ("silu", "gelu", "gelu_plain"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")
