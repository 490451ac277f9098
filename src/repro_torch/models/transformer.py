"""Decoder-only LM: forward, one-shot prefill, KV-cache decode and the LM
loss; torch port of ``repro.models.transformer`` for the dense, MoE and
vlm families.

The JAX package stacks layer params (L, ...) and scans them; here
``params["layers"]`` is a ``LayerStack`` of per-layer dicts walked by a
Python loop, and decode caches are a per-layer list of {"k", "v", "pos"}
dicts, a sliding-window layer's a ring of its window (``layer_windows``).
With ``cfg.moe`` every layer's FFN is a routed MoE layer
(``models.moe``): the grouped dispatch in forward and decode, one group a
token in prefill. With ``cfg.input_is_embeddings`` (qwen2-vl's stubbed
vision frontend) the inputs may be (B, S, d) embeddings, and an untied
model has no ``embed`` table; under M-RoPE the default positions are the
token index on all three streams.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor, SparseQTensor, asarray
from repro_torch.core.tree import LayerStack
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Params,
    attention,
    attention_decode,
    attn_init,
    dense_init,
    empty_kv_cache,
    lin,
    mlp,
    mlp_init,
    norm,
    norm_init,
    write_prefill_kv,
)


def layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    p: Params = {
        "ln1": norm_init(cfg.d_model, device),
        "attn": attn_init(gen, cfg, device),
        "ln2": norm_init(cfg.d_model, device),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(gen, cfg, cfg.moe, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random init from ``gen`` (a torch.Generator on ``device``). The
    draws differ from the JAX package's keys; compare through
    ``repro_torch.convert.params_from_numpy`` instead."""
    dt = getattr(torch, cfg.param_dtype)
    p: Params = {
        "layers": LayerStack(layer_init(gen, cfg, device)
                             for _ in range(cfg.num_layers)),
        "ln_f": norm_init(cfg.d_model, device),
    }
    if not cfg.input_is_embeddings or cfg.tie_embeddings:
        p["embed"] = torch.randn((cfg.vocab_size, cfg.d_model),
                                 generator=gen, dtype=dt, device=device) * (
            1.0 / cfg.d_model**0.5)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device)
    return p


def layer_windows(cfg: ModelConfig) -> list[Optional[int]]:
    """Each layer's sliding window (None = global attention): with a
    ``global_period`` the last layer of every period is global."""
    out: list[Optional[int]] = []
    for i in range(cfg.num_layers):
        if cfg.sliding_window is not None and cfg.global_period is not None:
            is_global = (i % cfg.global_period) == cfg.global_period - 1
            out.append(None if is_global else cfg.sliding_window)
        else:
            out.append(cfg.sliding_window)
    return out


def table_rows(table: Any, idx: torch.Tensor, dt) -> torch.Tensor:
    """Rows ``idx`` of an embedding table (V, d) in ``dt``. A QTensor or
    compressed table is gathered before it is dequantized: elementwise
    the same values, without dequantizing every row."""
    if isinstance(table, (QTensor, SparseQTensor)):
        codes = table.values[idx] if isinstance(table, QTensor) else \
            table.input_rows(idx)
        return (codes.to(torch.float32) * table.scale).to(dt)
    return table.to(dt)[idx]


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """tokens (B, S) int -> (B, S) rows of the table (``table_rows``), or
    float (B, S, d) embeddings passed through in the compute dtype.
    Scaled embeddings take sqrt(d_model) rounded to the compute dtype
    first, as the JAX package does (sqrt(3840) is 62.0 in bfloat16)."""
    dt = getattr(torch, cfg.compute_dtype)
    if tokens.is_floating_point():
        x = tokens.to(dt)
    else:
        x = table_rows(params["embed"], tokens, dt)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dt, device=x.device)
    return x


def logits_from_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = norm(x, params["ln_f"], cfg)
    if cfg.tie_embeddings:
        # the tied head is a dequantized float matmul, as in the JAX package
        return x @ asarray(params["embed"], x.dtype).T
    # the untied head is a projection: an integer dot under integer_lin
    return lin(x, params["head"], site="head")


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, mode: str
         ) -> tuple[torch.Tensor, Any]:
    """The residual FFN of a layer: (x + ffn(norm(x)), the MoE aux loss, 0
    for a dense layer). ``mode`` picks the MoE dispatch: ``"prefill"``
    routes every token in its own group (``moe_ffn_per_token``), so it
    drops no token that decode would keep; ``"forward"`` and ``"decode"``
    take the grouped capacity buffer (``moe_ffn``)."""
    h = norm(x, p["ln2"], cfg)
    if cfg.moe is None:
        return x + mlp(p["mlp"], h, cfg), 0.0
    fn = moe_lib.moe_ffn_per_token if mode == "prefill" else moe_lib.moe_ffn
    h, aux = fn(p["moe"], h, cfg, cfg.moe)
    return x + h, aux


def positions_for(b: int, s: int, cfg: ModelConfig, device
                  ) -> torch.Tensor:
    """The token index (B, S), on all three streams (3, B, S) under
    M-RoPE."""
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return pos.expand(3, b, s) if cfg.mrope_sections is not None else pos


def forward(params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cfg: ModelConfig = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of (B, S) tokens or (B, S, d) embeddings.
    Returns (logits, the MoE aux loss summed over the layers and divided
    by their number; 0 for the dense family)."""
    b, s = tokens.shape[:2]
    if positions is None:
        positions = positions_for(b, s, cfg, tokens.device)
    x = embed_tokens(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, win in zip(params["layers"], layer_windows(cfg)):
        x = x + attention(p["attn"], norm(x, p["ln1"], cfg), positions, cfg,
                          window=win)
        x, a = _ffn(p, x, cfg, "forward")
        aux = aux + a
    return logits_from_hidden(params, x, cfg), aux / max(cfg.num_layers, 1)


def prefill_step(params: Params, tokens: torch.Tensor, caches: list,
                 lengths: torch.Tensor, cfg: ModelConfig):
    """Consume whole left-aligned prompts ((B, S) tokens or (B, S, d)
    embeddings) in one batched pass: each layer's post-RoPE K/V go into
    the slot cache lanes, masked by ``lengths``. Returns (logits (B, S,
    V), new caches) with ``pos = lengths``."""
    b, s = tokens.shape[:2]
    positions = positions_for(b, s, cfg, tokens.device)
    x = embed_tokens(params, tokens, cfg)
    new_caches = []
    for p, cache, win in zip(params["layers"], caches, layer_windows(cfg)):
        h, (k, v) = attention(p["attn"], norm(x, p["ln1"], cfg), positions,
                              cfg, window=win, return_kv=True)
        x, _ = _ffn(p, x + h, cfg, "prefill")
        new_caches.append(write_prefill_kv(cache, k, v, lengths))
    return logits_from_hidden(params, x, cfg), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device) -> list:
    """A cache a layer: ``max_len`` slots, a ring of the window for a
    sliding-window layer."""
    return [empty_kv_cache(cfg, batch, max_len, win, dtype, device)
            for win in layer_windows(cfg)]


def decode_step(params: Params, token: torch.Tensor, caches: list,
                cfg: ModelConfig) -> tuple[torch.Tensor, Any]:
    """One decode step of (B, 1) tokens or (B, 1, d) embeddings; returns
    (logits (B, 1, V), new caches)."""
    x = embed_tokens(params, token, cfg)
    new_caches = []
    for p, cache, win in zip(params["layers"], caches, layer_windows(cfg)):
        h, nc = attention_decode(p["attn"], norm(x, p["ln1"], cfg), cache,
                                 cfg, window=win)
        x, _ = _ffn(p, x + h, cfg, "decode")
        new_caches.append(nc)
    return logits_from_hidden(params, x, cfg), new_caches


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int; -1 = ignore
    aux: Any = 0.0,
    aux_weight: float = 0.01,
    z_weight: float = 1e-4,
) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0, plus the aux
    loss and the z-loss (the squared log-partition), in float32."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, torch.clamp(labels, min=0).to(torch.int64)
                        [..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    nll = (lse - gold) * valid
    denom = torch.clamp(valid.sum(), min=1.0)
    z_loss = torch.sum((lse**2) * valid) / denom
    return torch.sum(nll) / denom + aux_weight * aux + z_weight * z_loss
