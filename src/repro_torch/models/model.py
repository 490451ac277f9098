"""build_model(cfg): the model bundle the serving engine drives; torch port
of ``repro.models.model`` for every family of the model zoo.

    init(seed)                          -> params on the model's device
    forward(params, batch)              -> logits
    loss(params, batch)                 -> scalar (``lm_loss`` on labels)
    init_caches(params, batch, L, dt)   -> decode caches
    decode(params, token, caches)       -> (logits, new caches)
    prefill(params, toks, caches, lens) -> (logits, new caches)
    merge_caches(old, new, active)      -> caches, inactive slots kept

Batches: {"tokens", "labels"}; the vlm family may feed "embeddings" (B,
S, d) and M-RoPE "positions" (3, B, S); the audio family (whisper, the
encoder-decoder) "frames" (B, S_enc, d) beside the decoder's "tokens".
The SSM family (mamba2) is the pure-Mamba2 LM: a ``LayerStack`` of
{"ln", "mamba"} layers, a tied embedding, and decode caches a per-layer
list of {"ssd", "conv"} dicts (``models.ssm``). The hybrid (jamba,
``models.hybrid``) mixes both kinds of layer and cache. The
encoder-decoder's caches are {"self": its per-layer KV caches, "cross":
the per-layer cross-attention K/V} (``models.encdec``). The engine
carries every kind alike (slot axis 0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.qtensor import QTensor, SparseQTensor, asarray
from repro_torch.core.tree import LayerStack, tree_leaves
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import Params, norm, norm_init


def cast_for_compute(params: Any, cfg: ModelConfig) -> Any:
    """Cast the float params that the JAX package holds as >=2-D arrays to
    the compute dtype; QTensors (int8) pass through.

    The JAX package casts its tree with the layers stacked, where a
    per-layer vector (a norm's gamma, a bias, mamba2's ``a_log``) is an
    (L, d) matrix; the port keeps a ``LayerStack`` of per-layer dicts
    there, so a leaf inside one counts one dimension more than it has.
    A plain list (the hybrid's layers, a list in the JAX package too) and
    the top-level vectors (``ln_f``) add none: their vectors stay
    float32."""
    dt = getattr(torch, cfg.compute_dtype)

    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: walk(v, stacked) for k, v in node.items()}
        if isinstance(node, LayerStack):
            return LayerStack(walk(v, stacked + 1) for v in node)
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, stacked) for v in node)
        if isinstance(node, torch.Tensor) and node.is_floating_point() and \
                node.ndim + stacked >= 2:
            return node.to(dt)
        return node

    return walk(params, 0)


# ---------------------------------------------------------------------------
# the pure-Mamba2 LM
# ---------------------------------------------------------------------------


def mamba_lm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = getattr(torch, cfg.param_dtype)
    return {
        "layers": LayerStack({"ln": norm_init(cfg.d_model, device),
                              "mamba": ssm_lib.mamba_init(gen, cfg, device)}
                             for _ in range(cfg.num_layers)),
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
    # (params, batch, max_len, dtype[, enc_out= for the encoder-decoder])
    init_caches: Callable[..., Any]
    decode: Callable[..., tuple]  # (params, token, caches)
    merge_caches: Callable[..., Any]  # (old, new, active (B,) bool)
    prefill: Callable[..., tuple]  # (params, tokens, caches, lengths)


def _tokens_or_embeddings(batch: dict) -> torch.Tensor:
    if "embeddings" in batch:
        return batch["embeddings"]
    if "frames" in batch:
        return batch["frames"]
    return batch["tokens"]


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg``'s family (dense, MoE or vlm decoder, the
    Mamba2 LM, the hybrid or the encoder-decoder) on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    cfg.validate()
    device = resolve_device(device)

    def generator(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gen

    cache_dtype = torch.bfloat16
    if cfg.family in ("dense", "moe", "vlm"):
        init_fn, decode_fn = transformer.init_params, transformer.decode_step
        prefill_fn = transformer.prefill_step

        def forward_fn(params, batch):
            return transformer.forward(params, _tokens_or_embeddings(batch),
                                       batch.get("positions"), cfg)

        def caches_fn(params, b, L, dt):
            return transformer.init_decode_caches(cfg, b, L, dt, device)
    elif cfg.family == "audio" or cfg.is_encoder_decoder:
        init_fn = encdec.init_params

        def decode_fn(params, tok, caches, cfg):
            logits, new = encdec.decode_step(params, tok, caches["self"],
                                             caches["cross"], cfg)
            return logits, {"self": new, "cross": caches["cross"]}

        def prefill_fn(params, toks, caches, lengths, cfg):
            logits, new = encdec.prefill_step(params, toks, caches["self"],
                                              caches["cross"], lengths, cfg)
            return logits, {"self": new, "cross": caches["cross"]}

        def forward_fn(params, batch):  # (logits, aux): no aux loss
            return encdec.forward(params, batch["frames"], batch["tokens"],
                                  cfg), 0.0

        def caches_fn(params, b, L, dt, enc_out=None):
            if enc_out is None:  # the engine's zero encoder: 1500 frames
                enc_out = torch.zeros((b, 1500, cfg.d_model), dtype=dt,
                                      device=device)
            return {"self": encdec.init_decode_caches(cfg, b, L, dt, device),
                    "cross": encdec.precompute_cross_kv(params, enc_out,
                                                        cfg)}
    elif cfg.family == "hybrid":
        init_fn, decode_fn = hybrid.init_params, hybrid.decode_step
        prefill_fn = hybrid.prefill_step

        def forward_fn(params, batch):
            return hybrid.forward(params, batch["tokens"], None, cfg)

        def caches_fn(params, b, L, dt):
            return hybrid.init_decode_caches(cfg, b, L, dt, device)
    elif cfg.family == "ssm":
        init_fn, decode_fn = mamba_lm_init, mamba_lm_decode
        prefill_fn, cache_dtype = mamba_lm_prefill, torch.float32

        def forward_fn(params, batch):  # (logits, aux): no aux loss
            return mamba_lm_forward(params, batch["tokens"], cfg), 0.0

        def caches_fn(params, b, L, dt):  # O(1) in the sequence: no max_len
            return mamba_lm_init_caches(cfg, b, dt, device)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")

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
        init_caches=lambda params, b, L, dt=cache_dtype, **kw: caches_fn(
            params, b, L, dt, **kw),
        decode=lambda params, tok, caches: decode_fn(
            cast_for_compute(params, cfg), tok, caches, cfg),
        merge_caches=merge_caches_on_axis(0),  # per-layer lists: (B, ...)
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
