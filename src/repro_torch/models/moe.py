"""Mixture-of-Experts layer: top-k router and capacity-buffer dispatch /
combine; torch port of ``repro.models.moe``.

Tokens route per batch row ("group"): softmax over the experts, top-k,
gates normalized over k, and the load-balance aux loss of Shazeer et al.
Each (token, k) assignment takes the next free slot of its expert's
buffer in token-major order, so earlier tokens win capacity; an
assignment past the capacity is dropped (GShard semantics) into a
scratch slot that is discarded. The expert FFNs are one einsum over the
expert axis on the dequantized expert stack, as in the JAX package: they
are float products, not integer PQS dots.

The JAX package's sequence-folded one-hot dispatch (``moe_local_groups``
under a model axis) needs a mesh; the port has none, so ``moe_ffn`` is
the grouped path, which the JAX package takes without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.qtensor import asarray
from repro_torch.models.layers import Params, dense_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, mcfg: MoEConfig,
             device) -> Params:
    d, ff, e = cfg.d_model, mcfg.d_ff, mcfg.num_experts
    dt = getattr(torch, cfg.param_dtype)
    scale_in = (2.0 / (d + ff)) ** 0.5

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device) * scale_in

    return {
        "router": dense_init(gen, d, e, torch.float32, device),  # f32
        "w_gate": normal((e, d, ff)),
        "w_up": normal((e, d, ff)),
        "w_out": normal((e, ff, d)),
    }


def capacity(tokens_per_group: int, mcfg: MoEConfig) -> int:
    c = int(tokens_per_group * mcfg.top_k * mcfg.capacity_factor
            / mcfg.num_experts)
    return max(c, mcfg.top_k)


def _act(cfg: ModelConfig):
    if cfg.activation == "silu":
        return F.silu
    return lambda h: F.gelu(h, approximate="tanh")  # jax.nn.gelu's default


def route(x: torch.Tensor, router_w: torch.Tensor, mcfg: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of x (G, S, d). Returns (expert_idx (G, S, k) int64,
    gates (G, S, k) f32 normalized over k, the load-balance aux loss: E
    times the sum over experts of the fraction of tokens whose top-1 is
    e and the mean probability of e). ``torch.topk`` orders the k
    experts by descending probability, as ``jax.lax.top_k`` does."""
    logits = (x.to(torch.float32) @ router_w).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mcfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    frac = F.one_hot(idx[..., 0], mcfg.num_experts).to(
        torch.float32).mean(dim=(0, 1))
    mean_p = probs.mean(dim=(0, 1))
    aux = torch.sum(frac * mean_p) * mcfg.num_experts
    return idx, gates, aux


def _positions_in_expert(idx: torch.Tensor, num_experts: int
                         ) -> torch.Tensor:
    """Arrival order of each (token, k) assignment within its expert:
    idx (..., T, k) flattened to (..., T k) token-major (earlier tokens
    win capacity), a cumulative count per expert. Returns (..., T, k)."""
    *lead, t, k = idx.shape
    flat = idx.reshape(*lead, t * k)
    onehot = F.one_hot(flat, num_experts).to(torch.int32)  # (..., Tk, E)
    pos_all = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - 1
    pos = torch.gather(pos_all, -1, flat[..., None])[..., 0]
    return pos.reshape(*lead, t, k)


def _experts(params: Params, buf: torch.Tensor, cfg: ModelConfig,
             dtype) -> torch.Tensor:
    """The expert FFNs on a (G, E, C, d) buffer: E is a batch axis."""
    act = _act(cfg)
    wg = asarray(params["w_gate"], dtype)
    wu = asarray(params["w_up"], dtype)
    wo = asarray(params["w_out"], dtype)
    h = act(torch.einsum("gecd,edf->gecf", buf, wg)) * torch.einsum(
        "gecd,edf->gecf", buf, wu)
    return torch.einsum("gecf,efd->gecd", h, wo)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ModelConfig,
            mcfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN forward on x (G, S, d), G the batch rows; returns (out (G,
    S, d), aux loss). The JAX package's grouped dispatch: scatter each
    group's kept assignments into a (G, E, C + 1, d) buffer (slot C
    collects the dropped ones and is discarded), run the experts on (G,
    E, C, d), gather each assignment's result back and sum it over k
    weighted by its gate (0 for a dropped one)."""
    g, s, d = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    c = capacity(s, mcfg)
    idx, gates, aux = route(x, asarray(params["router"], torch.float32), mcfg)
    pos = _positions_in_expert(idx, e)  # (G, S, k)
    keep = pos < c
    gates = torch.where(keep, gates, 0.0)
    pos_c = torch.where(keep, pos, c).to(torch.int64)
    rows = torch.arange(g, device=x.device)[:, None].expand(g, s * k)
    flat_e, flat_c = idx.reshape(g, s * k), pos_c.reshape(g, s * k)
    buf = torch.zeros((g, e, c + 1, d), dtype=x.dtype, device=x.device)
    xk = x[:, :, None, :].expand(g, s, k, d).reshape(g, s * k, d)
    # a kept slot receives one assignment; only the scratch slot sums
    buf.index_put_((rows, flat_e, flat_c), xk, accumulate=True)
    y = _experts(params, buf[:, :, :c], cfg, x.dtype)  # (G, E, C, d)
    y_pad = torch.cat([y, torch.zeros((g, e, 1, d), dtype=y.dtype,
                                      device=y.device)], dim=2)
    got = y_pad[rows, flat_e, flat_c].reshape(g, s, k, d)
    out = torch.sum(got * gates[..., None].to(y.dtype), dim=2)
    return out, aux


def moe_ffn_per_token(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      mcfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-identical MoE for one-shot batched prefill: every token
    routes in its own group of one, the capacity situation of a decode
    step (capacity >= top_k: nothing is dropped), so prefill never drops
    a token that decode would keep."""
    g, s, d = x.shape
    out, aux = moe_ffn(params, x.reshape(g * s, 1, d), cfg, mcfg)
    return out.reshape(g, s, d), aux


def moe_ffn_dense(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  mcfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropless oracle: every expert on every token, gate-masked (E / k
    times the dispatch's work); the dispatch must match it wherever no
    assignment was dropped."""
    act = _act(cfg)
    idx, gates, aux = route(x, asarray(params["router"], torch.float32), mcfg)
    wg = asarray(params["w_gate"], x.dtype)
    wu = asarray(params["w_up"], x.dtype)
    wo = asarray(params["w_out"], x.dtype)
    h = act(torch.einsum("gsd,edf->gsef", x, wg)) * torch.einsum(
        "gsd,edf->gsef", x, wu)
    y = torch.einsum("gsef,efd->gsed", h, wo)  # (G, S, E, d)
    dense_gates = torch.zeros(y.shape[:3], dtype=torch.float32,
                              device=x.device)
    dense_gates.scatter_add_(2, idx, gates)
    out = torch.sum(y * dense_gates[..., None].to(y.dtype), dim=2)
    return out, aux
