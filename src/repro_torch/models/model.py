"""build_model(cfg): the model bundle the serving engine drives; torch port
of ``repro.models.model`` for the dense family.

    init(seed)                          -> params on the model's device
    forward(params, batch)              -> logits
    loss(params, batch)                 -> scalar (``lm_loss`` on labels)
    init_caches(params, batch, L, dt)   -> decode caches
    decode(params, token, caches)       -> (logits, new caches)
    prefill(params, toks, caches, lens) -> (logits, new caches)
    merge_caches(old, new, active)      -> caches, inactive slots kept
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer


def cast_for_compute(params: Any, cfg: ModelConfig) -> Any:
    """Cast >=2-D float params to the compute dtype; QTensors (int8) pass
    through."""
    dt = getattr(torch, cfg.compute_dtype)

    def conv(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and \
                leaf.is_floating_point():
            return leaf.to(dt)
        return leaf

    return tree_map(conv, params)


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
    """The dense decoder on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    cfg.validate()
    device = resolve_device(device)

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return transformer.init_params(gen, cfg, device)

    def fwd(params, batch):
        return transformer.forward(cast_for_compute(params, cfg),
                                   batch["tokens"], batch.get("positions"),
                                   cfg)[0]

    def loss(params, batch):
        logits, aux = transformer.forward(
            cast_for_compute(params, cfg), batch["tokens"],
            batch.get("positions"), cfg)
        return transformer.lm_loss(logits, batch["labels"], aux)

    return Model(
        cfg=cfg,
        device=device,
        init=init,
        forward=fwd,
        loss=loss,
        init_caches=lambda params, b, L, dt=torch.bfloat16:
            transformer.init_decode_caches(cfg, b, L, dt, device),
        decode=lambda params, tok, caches: transformer.decode_step(
            cast_for_compute(params, cfg), tok, caches, cfg),
        merge_caches=merge_caches_on_axis(0),  # per-layer list: (B, ...)
        prefill=lambda params, toks, caches, lengths: transformer.prefill_step(
            cast_for_compute(params, cfg), toks, caches, lengths, cfg),
    )

