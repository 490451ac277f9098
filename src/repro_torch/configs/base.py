"""Model configuration schema of the port: the fields of
``repro.configs.base.ModelConfig`` that the dense decoder family reads.

Families other than ``dense``, layer norm, the plain-GELU MLP, QK norm,
an untied head, embedding scaling, sliding-window attention, M-RoPE,
logit soft-capping and query-chunked attention are not ported yet;
``validate`` refuses a config that asks for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family ported so far)
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
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    norm: str = "rmsnorm"
    activation: str = "silu"  # silu | gelu (gated MLP)
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    max_seq_len: int = 131_072
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def validate(self) -> None:
        if self.family != "dense":
            raise NotImplementedError(
                f"family {self.family!r} is not ported yet (dense only)")
        if (self.sliding_window is not None or self.attn_logit_softcap
                or self.qk_norm or self.scale_embeddings
                or not self.tie_embeddings or self.norm != "rmsnorm"
                or self.activation not in ("silu", "gelu")):
            raise NotImplementedError(
                "this config needs decoder features not ported yet (see "
                "the module docstring)")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be a multiple of num_kv_heads")
