"""Model configuration schema of the port: the fields of
``repro.configs.base.ModelConfig`` that the dense, MoE and SSM families
read, and those that name what is not ported yet.

The dense family is ported whole: sliding-window attention with
gemma3's 1-global-in-``global_period`` pattern, logit soft-capping, QK
norm, scaled embeddings, an untied head, layer norm, the gated SiLU /
GELU and the plain-GELU MLP, and query-chunked attention. So are the
MoE family (granite-moe: ``MoEConfig``, top-k routed experts in every
layer) and the SSM family (mamba2: ``SSMConfig``, chunked SSD).
``validate`` refuses the other families (hybrid, encoder-decoder, vlm,
audio), M-RoPE (``mrope_sections``) and embedding inputs
(``input_is_embeddings``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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
    family: str  # dense | moe | ssm (the families ported so far)
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
    mrope_sections: Optional[tuple[int, ...]] = None  # not ported
    sliding_window: Optional[int] = None  # local-attention window
    global_period: Optional[int] = None  # gemma3: 1 global per N layers
    attn_logit_softcap: Optional[float] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu (gated) | gelu (gated) | gelu_plain
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: x *= sqrt(d_model)
    input_is_embeddings: bool = False  # not ported
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # not ported: a config that sets it is refused
    is_encoder_decoder: bool = False
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
        if self.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet (dense, moe and "
                "ssm only)")
        if self.family == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: the moe family needs moe=")
        if self.family == "ssm" and self.ssm is None:
            raise ValueError(f"{self.name}: the ssm family needs ssm=")
        for field, missing in (("is_encoder_decoder", "the encoder-decoder"),
                               ("mrope_sections", "M-RoPE"),
                               ("input_is_embeddings", "embedding inputs"),
                               ("moe_local_groups",
                                "the sequence-folded MoE dispatch of a "
                                "mesh")):
            if getattr(self, field):
                raise NotImplementedError(
                    f"{self.name}: {field} asks for {missing}, not ported "
                    "yet")
        if self.norm not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.activation not in ("silu", "gelu", "gelu_plain"):
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")
