"""build_model(cfg): the model bundle the serving engine drives; torch port
of ``repro.models.model`` for the dense, MoE and SSM families.

    init(seed)                          -> params on the model's device
    forward(params, batch)              -> logits
    loss(params, batch)                 -> scalar (``lm_loss`` on labels)
    init_caches(params, batch, L, dt)   -> decode caches
    decode(params, token, caches)       -> (logits, new caches)
    prefill(params, toks, caches, lens) -> (logits, new caches)
    merge_caches(old, new, active)      -> caches, inactive slots kept

The SSM family (mamba2) is the pure-Mamba2 LM: a list of {"ln", "mamba"}
layers, a tied embedding, and decode caches a per-layer list of {"ssd",
"conv"} dicts (``models.ssm``), which the engine carries like the KV
caches (slot axis 0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor, SparseQTensor, asarray
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.models.layers import Params, norm, norm_init


def cast_for_compute(params: Any, cfg: ModelConfig) -> Any:
    """Cast the float params that the JAX package holds as >=2-D arrays to
    the compute dtype; QTensors (int8) pass through.

    The JAX package casts the layer-stacked tree, where a per-layer vector
    (a norm's gamma, a bias, mamba2's ``a_log``) is an (L, d) matrix; the
    port keeps one dict a layer, so a leaf under ``params["layers"]``
    counts one dimension more than it has. Top-level vectors (``ln_f``)
    are not stacked there and stay float32."""
    dt = getattr(torch, cfg.compute_dtype)

    def conv(leaf, stacked):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and \
                leaf.ndim + stacked >= 2:
            return leaf.to(dt)
        return leaf

    return {k: tree_map(lambda leaf: conv(leaf, int(k == "layers")), v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# the pure-Mamba2 LM
# ---------------------------------------------------------------------------


def mamba_lm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    return {
        "layers": [{"ln": norm_init(cfg.d_model, device),
                    "mamba": ssm_lib.mamba_init(gen, cfg, device)}
                   for _ in range(cfg.num_layers)],
        "ln_f": norm_init(cfg.d_model, device),
        "embed": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                             dtype=dt, device=device) * (1.0 / cfg.d_model**0.5),
    }


def _mamba_logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = norm(x, params["ln_f"], cfg)
    return x @ asarray(params["embed"], x.dtype).T  # the tied head


def mamba_lm_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    x = transformer.embed_tokens(params, tokens, cfg)
    for p in params["layers"]:
        h, _ = ssm_lib.mamba_forward(p["mamba"], norm(x, p["ln"], cfg), cfg)
        x = x + h
    return _mamba_logits(params, x, cfg)


def mamba_lm_init_caches(cfg: ModelConfig, batch: int, dtype, device
                         ) -> list:
    """A {"ssd", "conv"} cache a layer; O(1) in the sequence, so there is
    no ``max_len``."""
    return [ssm_lib.empty_ssm_cache(cfg, batch, dtype, device)
            for _ in range(cfg.num_layers)]


def mamba_lm_prefill(params: Params, tokens: torch.Tensor, caches: list,
                     lengths: torch.Tensor, cfg: ModelConfig):
    """One-shot batched prefill: a full-sequence SSD a layer with dt zeroed
    past each lane's length (an identity recurrence there), giving each
    layer's {"ssd", "conv"} cache at exactly ``lengths`` tokens."""
    x = transformer.embed_tokens(params, tokens, cfg)
    new_caches = []
    for p, cache in zip(params["layers"], caches):
        h, nc = ssm_lib.mamba_forward(p["mamba"], norm(x, p["ln"], cfg), cfg,
                                      h0=cache["ssd"], lengths=lengths)
        x = x + h
        new_caches.append(nc)
    return _mamba_logits(params, x, cfg), new_caches


def mamba_lm_decode(params: Params, token: torch.Tensor, caches: list,
                    cfg: ModelConfig):
    x = transformer.embed_tokens(params, token, cfg)
    new_caches = []
    for p, cache in zip(params["layers"], caches):
        h, nc = ssm_lib.mamba_step(p["mamba"], norm(x, p["ln"], cfg), cache,
                                   cfg)
        x = x + h
        new_caches.append(nc)
    return _mamba_logits(params, x, cfg), new_caches


def merge_caches_on_axis(axis: int) -> Callable[[Any, Any, torch.Tensor], Any]:
    """``merge(old, new, active)``: active (B,) bool lanes take the new
    cache, inactive lanes keep their old state (slot isolation)."""

    def merge(old: Any, new: Any, active: torch.Tensor) -> Any:
        def sel(o, n):
            shape = [1] * o.ndim
            shape[axis] = active.shape[0]
            return torch.where(active.reshape(shape), n, o)

        if isinstance(old, dict):
            return {k: merge(old[k], new[k], active) for k in old}
        if isinstance(old, (list, tuple)):
            return type(old)(merge(o, n, active) for o, n in zip(old, new))
        return sel(old, new)

    return merge


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]  # (seed) -> params
    forward: Callable[..., torch.Tensor]  # (params, batch) -> logits
    loss: Callable[..., torch.Tensor]  # (params, batch) -> scalar
    init_caches: Callable[..., Any]  # (params, batch, max_len, dtype)
    decode: Callable[..., tuple]  # (params, token, caches)
    merge_caches: Callable[..., Any]  # (old, new, active (B,) bool)
    prefill: Callable[..., tuple]  # (params, tokens, caches, lengths)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg``'s family (dense or MoE decoder, or the Mamba2
    LM) on ``device`` (CUDA unless the caller asks for the CPU)."""
    cfg.validate()
    device = resolve_device(device)

    def generator(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen

    if cfg.family == "ssm":
        init_fn, decode_fn = mamba_lm_init, mamba_lm_decode
        prefill_fn, cache_dtype = mamba_lm_prefill, torch.float32

        def forward_fn(params, batch):  # (logits, aux): no aux loss
            return mamba_lm_forward(params, batch["tokens"], cfg), 0.0

        def caches_fn(b, L, dt):  # O(1) in the sequence: no max_len
            return mamba_lm_init_caches(cfg, b, dt, device)
    else:
        init_fn, decode_fn = transformer.init_params, transformer.decode_step
        prefill_fn, cache_dtype = transformer.prefill_step, torch.bfloat16

        def forward_fn(params, batch):
            return transformer.forward(params, batch["tokens"],
                                       batch.get("positions"), cfg)

        def caches_fn(b, L, dt):
            return transformer.init_decode_caches(cfg, b, L, dt, device)

    def loss(params, batch):
        logits, aux = forward_fn(cast_for_compute(params, cfg), batch)
        return transformer.lm_loss(logits, batch["labels"], aux)

    return Model(
        cfg=cfg,
        device=device,
        init=lambda seed=0: init_fn(generator(seed), cfg, device),
        forward=lambda params, batch: forward_fn(
            cast_for_compute(params, cfg), batch)[0],
        loss=loss,
        init_caches=lambda params, b, L, dt=cache_dtype: caches_fn(b, L, dt),
        decode=lambda params, tok, caches: decode_fn(
            cast_for_compute(params, cfg), tok, caches, cfg),
        merge_caches=merge_caches_on_axis(0),  # per-layer list: (B, ...)
        prefill=lambda params, toks, caches, lengths: prefill_fn(
            cast_for_compute(params, cfg), toks, caches, lengths, cfg),
    )


def _leaf_sizes(leaf) -> int:
    """Elements of a leaf as the JAX package's pytree counts them: a
    QTensor's or SparseQTensor's arrays (not the port's ``values_t``
    copy), a tensor's elements, nothing for a plain value."""
    if isinstance(leaf, (QTensor, SparseQTensor)):
        parts = [leaf.values, leaf.scale, leaf.act_corr]
        if isinstance(leaf, SparseQTensor):
            parts.append(leaf.indices)
        if leaf.act_qparams is not None:
            parts += [leaf.act_qparams.scale, leaf.act_qparams.offset]
        return sum(int(p.numel()) for p in parts if p is not None)
    return int(leaf.numel()) if isinstance(leaf, torch.Tensor) else 0


def param_count(params: Any) -> int:
    return sum(_leaf_sizes(leaf) for leaf in tree_leaves(params))


def active_param_count(cfg: ModelConfig, total: int) -> int:
    """MoE-aware active parameter count (for 6 N_active D model FLOPs):
    the experts of each MoE layer count top_k / num_experts of their
    size."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    expert = 3 * cfg.d_model * m.d_ff * m.num_experts
    n_moe_layers = len([i for i in range(cfg.num_layers)
                        if i % m.layer_period == m.layer_offset])
    expert_total = expert * n_moe_layers
    active_expert = expert_total * m.top_k / m.num_experts
    return int(total - expert_total + active_expert)
