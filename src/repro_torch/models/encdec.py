"""Whisper-style encoder-decoder transformer; torch port of
``repro.models.encdec``.

The conv / mel frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings (B, S_enc, d_model), adds sinusoidal
positions and runs bidirectional attention without RoPE; the decoder adds
learned positions (``pos_embed``) to its token embeddings and runs causal
self-attention, cross-attention into the encoder states and the plain
GELU MLP. Both stacks are ``LayerStack``s (the JAX package stacks them).

Decode keeps two caches: the decoder's per-layer self-attention KV
caches and the cross-attention K/V, computed once from the encoder
states (``precompute_cross_kv``, whose projections carry no site name, as
in the JAX package).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import asarray
from repro_torch.core.tree import LayerStack
from repro_torch.models.layers import (
    Params,
    _sdpa,
    attention,
    attention_decode,
    attn_init,
    empty_kv_cache,
    lin,
    mlp,
    mlp_init,
    norm,
    norm_init,
    write_prefill_kv,
)
from repro_torch.models.transformer import table_rows


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding (length, channels), float32."""
    log_timescale = torch.log(torch.tensor(10000.0, device=device)) / (
        channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                  device=device))
    scaled = torch.arange(length, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def enc_layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {
        "ln1": norm_init(cfg.d_model, device),
        "attn": attn_init(gen, cfg, device),
        "ln2": norm_init(cfg.d_model, device),
        "mlp": mlp_init(gen, cfg, device),
    }


def dec_layer_init(gen: torch.Generator, cfg: ModelConfig, device
                   ) -> Params:
    return {
        "ln1": norm_init(cfg.d_model, device),
        "attn": attn_init(gen, cfg, device),
        "ln_x": norm_init(cfg.d_model, device),
        "xattn": attn_init(gen, cfg, device),
        "ln2": norm_init(cfg.d_model, device),
        "mlp": mlp_init(gen, cfg, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random init from ``gen``; the draws differ from the JAX package's
    keys (compare through ``repro_torch.convert.params_from_numpy``)."""
    dt = getattr(torch, cfg.param_dtype)
    return {
        "enc_layers": LayerStack(enc_layer_init(gen, cfg, device)
                                 for _ in range(cfg.encoder_layers)),
        "enc_ln_f": norm_init(cfg.d_model, device),
        "dec_layers": LayerStack(dec_layer_init(gen, cfg, device)
                                 for _ in range(cfg.num_layers)),
        "dec_ln_f": norm_init(cfg.d_model, device),
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             dtype=dt, device=device) * (1.0 / cfg.d_model**0.5),
        "pos_embed": torch.randn((cfg.max_seq_len, cfg.d_model),
                                 generator=gen, dtype=dt, device=device)
        * 0.01,
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames (B, S_enc, d_model), the stubbed frontend's output -> the
    encoder states (B, S_enc, d_model)."""
    dt = getattr(torch, cfg.compute_dtype)
    b, s, _ = frames.shape
    x = frames.to(dt) + sinusoids(s, cfg.d_model, frames.device).to(dt)[None]
    positions = _positions(b, s, frames.device)
    for p in params["enc_layers"]:
        x = x + attention(p["attn"], norm(x, p["ln1"], cfg), positions, cfg,
                          causal=False, use_rope=False)
        x = x + mlp(p["mlp"], norm(x, p["ln2"], cfg), cfg)
    return norm(x, params["enc_ln_f"], cfg)


def _embed(params: Params, tokens: torch.Tensor, pos: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Token rows plus the learned position rows ``pos`` (broadcast over
    the batch or one a sequence)."""
    dt = getattr(torch, cfg.compute_dtype)
    return table_rows(params["embed"], tokens, dt) + table_rows(
        params["pos_embed"], pos, dt)


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = norm(x, params["dec_ln_f"], cfg)
    return x @ asarray(params["embed"], x.dtype).T  # the tied head


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder forward of (B, S_dec) tokens -> logits (B,
    S_dec, V)."""
    b, s = tokens.shape
    x = _embed(params, tokens, torch.arange(s, device=tokens.device)[None],
               cfg)
    positions = _positions(b, s, tokens.device)
    for p in params["dec_layers"]:
        x = x + attention(p["attn"], norm(x, p["ln1"], cfg), positions, cfg,
                          causal=True, use_rope=False)
        x = x + attention(p["xattn"], norm(x, p["ln_x"], cfg), positions,
                          cfg, kv_x=enc_out, use_rope=False)
        x = x + mlp(p["mlp"], norm(x, p["ln2"], cfg), cfg)
    return _logits(params, x, cfg)


def forward(params: Params, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    return decode_train(params, tokens, encode(params, frames, cfg), cfg)


# ---------------------------------------------------------------------------
# decode (incremental)
# ---------------------------------------------------------------------------


def precompute_cross_kv(params: Params, enc_out: torch.Tensor,
                        cfg: ModelConfig) -> list:
    """Each decoder layer's cross-attention {"k", "v"} (B, S_enc, G, hd)
    from the encoder states."""
    b, s, _ = enc_out.shape
    g, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    out = []
    for p in params["dec_layers"]:
        k = lin(enc_out, p["xattn"]["wk"])
        v = lin(enc_out, p["xattn"]["wv"])
        if cfg.qkv_bias:
            k = k + asarray(p["xattn"]["bk"], k.dtype)
            v = v + asarray(p["xattn"]["bv"], v.dtype)
        out.append({"k": k.reshape(b, s, g, hd), "v": v.reshape(b, s, g, hd)})
    return out


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device) -> list:
    """The decoder's self-attention KV cache a layer (``max_len`` slots)."""
    return [empty_kv_cache(cfg, batch, max_len, None, dtype, device)
            for _ in range(cfg.num_layers)]


def _cross_attend_step(p: Params, x: torch.Tensor, xkv: dict,
                       cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of x (B, Sq, d) into precomputed encoder K/V."""
    b, sq = x.shape[0], x.shape[1]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = lin(x, p["wq"], site="wq")
    if cfg.qkv_bias:
        q = q + asarray(p["bq"], q.dtype)
    q = q.reshape(b, sq, h, hd)
    k = xkv["k"].to(x.dtype)
    v = xkv["v"].to(x.dtype)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=x.device)
    o = _sdpa(q, k, v, mask, cfg.attn_logit_softcap)
    return lin(o.reshape(b, sq, h * hd), p["wo"], site="wo")


def prefill_step(params: Params, tokens: torch.Tensor, caches: list,
                 cross_kv: list, lengths: torch.Tensor, cfg: ModelConfig):
    """One batched decoder prefill of left-aligned prompts: each layer's
    self K/V written into the slot caches (masked by ``lengths``), the
    cross-attention reading the precomputed encoder K/V as decode does.
    Returns (logits (B, S, V), new self caches)."""
    b, s = tokens.shape
    x = _embed(params, tokens, torch.arange(s, device=tokens.device)[None],
               cfg)
    positions = _positions(b, s, tokens.device)
    new_caches = []
    for p, cache, xkv in zip(params["dec_layers"], caches, cross_kv):
        h, (k, v) = attention(p["attn"], norm(x, p["ln1"], cfg), positions,
                              cfg, causal=True, use_rope=False,
                              return_kv=True)
        x = x + h
        x = x + _cross_attend_step(p["xattn"], norm(x, p["ln_x"], cfg), xkv,
                                   cfg)
        x = x + mlp(p["mlp"], norm(x, p["ln2"], cfg), cfg)
        new_caches.append(write_prefill_kv(cache, k, v, lengths))
    return _logits(params, x, cfg), new_caches


def decode_step(params: Params, token: torch.Tensor, caches: list,
                cross_kv: list, cfg: ModelConfig):
    """One decode step of (B, 1) tokens at each sequence's position (layer
    0's cache ``pos``); returns (logits (B, 1, V), new self caches)."""
    pos = caches[0]["pos"]  # (B,)
    x = _embed(params, token, pos[:, None], cfg)
    new_caches = []
    for p, cache, xkv in zip(params["dec_layers"], caches, cross_kv):
        h, nc = attention_decode(p["attn"], norm(x, p["ln1"], cfg), cache,
                                 cfg, use_rope=False)
        x = x + h
        x = x + _cross_attend_step(p["xattn"], norm(x, p["ln_x"], cfg), xkv,
                                   cfg)
        x = x + mlp(p["mlp"], norm(x, p["ln2"], cfg), cfg)
        new_caches.append(nc)
    return _logits(params, x, cfg), new_caches
