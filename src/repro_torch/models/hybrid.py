"""Jamba-style hybrid: Mamba2 and attention layers interleaved, MoE FFNs on
every other layer; torch port of ``repro.models.hybrid``.

Layer i mixes with attention when ``i % attn_period == attn_offset``
(jamba v0.1: period 8, offset 4) and with a Mamba2 block otherwise; its
FFN is MoE when ``i % moe.layer_period == moe.layer_offset`` (the odd
layers) and a dense MLP otherwise. The layers differ, so ``"layers"`` is
a plain list of per-layer dicts, as in the JAX package (not a
``LayerStack``: the tree functions take its leaves one by one). Jamba's
attention layers carry no positional encoding (the SSM layers encode
order). Decode caches are a per-layer list: {"k", "v", "pos"} for an
attention layer, {"ssd", "conv"} for a Mamba2 one.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import asarray
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    Params,
    attention,
    attention_decode,
    attn_init,
    empty_kv_cache,
    mlp,
    mlp_init,
    norm,
    norm_init,
    write_prefill_kv,
)
from repro_torch.models.ssm import (
    empty_ssm_cache,
    mamba_forward,
    mamba_init,
    mamba_step,
)
from repro_torch.models.transformer import table_rows


def is_attn_layer(i: int, cfg: ModelConfig) -> bool:
    return i % cfg.attn_period == cfg.attn_offset


def is_moe_layer(i: int, cfg: ModelConfig) -> bool:
    m = cfg.moe
    return m is not None and i % m.layer_period == m.layer_offset


def layer_init(gen: torch.Generator, i: int, cfg: ModelConfig, device
               ) -> Params:
    p: Params = {"ln1": norm_init(cfg.d_model, device),
                 "ln2": norm_init(cfg.d_model, device)}
    if is_attn_layer(i, cfg):
        p["attn"] = attn_init(gen, cfg, device)
    else:
        p["mamba"] = mamba_init(gen, cfg, device)
    if is_moe_layer(i, cfg):
        p["moe"] = moe_lib.moe_init(gen, cfg, cfg.moe, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device, d_ff=cfg.d_ff)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    """Random init from ``gen``; the draws differ from the JAX package's
    keys (compare through ``repro_torch.convert.params_from_numpy``)."""
    dt = getattr(torch, cfg.param_dtype)
    return {
        "layers": [layer_init(gen, i, cfg, device)
                   for i in range(cfg.num_layers)],
        "ln_f": norm_init(cfg.d_model, device),
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             dtype=dt, device=device) * (1.0 / cfg.d_model**0.5),
    }


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    return table_rows(params["embed"], tokens,
                      getattr(torch, cfg.compute_dtype))


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = norm(x, params["ln_f"], cfg)
    return x @ asarray(params["embed"], x.dtype).T  # the tied head


def _ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, per_token: bool
         ) -> tuple[torch.Tensor, Any]:
    """x + the layer's FFN of norm(x), and the MoE aux loss (0 for an MLP
    layer). ``per_token`` routes a token a group (the prefill's
    dispatch, which drops no token that decode would keep)."""
    h = norm(x, p["ln2"], cfg)
    if "moe" not in p:
        return x + mlp(p["mlp"], h, cfg), 0.0
    fn = moe_lib.moe_ffn_per_token if per_token else moe_lib.moe_ffn
    h, aux = fn(p["moe"], h, cfg, cfg.moe)
    return x + h, aux


def forward(params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cfg: ModelConfig = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of (B, S) tokens. Returns (logits, the MoE aux
    loss summed over the layers and divided by their number)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        h = norm(x, p["ln1"], cfg)
        if "attn" in p:
            h = attention(p["attn"], h, positions, cfg, use_rope=False)
        else:
            h, _ = mamba_forward(p["mamba"], h, cfg)
        x, a = _ffn(p, x + h, cfg, per_token=False)
        aux = aux + a
    return _logits(params, x, cfg), aux / max(cfg.num_layers, 1)


def prefill_step(params: Params, tokens: torch.Tensor, caches: list,
                 lengths: torch.Tensor, cfg: ModelConfig):
    """One batched prefill of left-aligned prompts across the interleave:
    an attention layer writes its K/V into the slot caches (masked by
    ``lengths``), a Mamba2 layer runs the SSD with dt zeroed past each
    lane's length, so both kinds of cache end at each slot's token
    count."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = _embed(params, tokens, cfg)
    new_caches = []
    for p, cache in zip(params["layers"], caches):
        h = norm(x, p["ln1"], cfg)
        if "attn" in p:
            h, (k, v) = attention(p["attn"], h, positions, cfg,
                                  use_rope=False, return_kv=True)
            new_caches.append(write_prefill_kv(cache, k, v, lengths))
        else:
            h, nc = mamba_forward(p["mamba"], h, cfg, h0=cache["ssd"],
                                  lengths=lengths)
            new_caches.append(nc)
        x, _ = _ffn(p, x + h, cfg, per_token=True)
    return _logits(params, x, cfg), new_caches


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device) -> list:
    """A cache a layer: ``max_len`` KV slots for an attention layer, the
    {"ssd", "conv"} state of a Mamba2 one."""
    return [empty_kv_cache(cfg, batch, max_len, None, dtype, device)
            if is_attn_layer(i, cfg)
            else empty_ssm_cache(cfg, batch, dtype, device)
            for i in range(cfg.num_layers)]


def decode_step(params: Params, token: torch.Tensor, caches: list,
                cfg: ModelConfig) -> tuple[torch.Tensor, list]:
    """One decode step; returns (logits (B, 1, V), new caches)."""
    x = _embed(params, token, cfg)
    new_caches = []
    for p, cache in zip(params["layers"], caches):
        h = norm(x, p["ln1"], cfg)
        if "attn" in p:
            h, nc = attention_decode(p["attn"], h, cache, cfg,
                                     use_rope=False)
        else:
            h, nc = mamba_step(p["mamba"], h, cache, cfg)
        new_caches.append(nc)
        x, _ = _ffn(p, x + h, cfg, per_token=False)
    return _logits(params, x, cfg), new_caches
