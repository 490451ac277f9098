"""Narrow-accumulator simulation, torch port of ``repro.core.overflow``:
explicit partial products and the accumulation policies. The overflow
census is not ported yet."""

from __future__ import annotations

import torch

from repro_torch.core.sorted_accum import (
    monotone_accumulate,
    sorted_order,
    tiled_seq_order,
    tiled_sorted_order,
)


def partial_products(wq: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """wq (out, K), xq (batch, K) -> (batch, out, K) int32 products."""
    return wq.to(torch.int32)[None, :, :] * xq.to(torch.int32)[:, None, :]


def accumulate(
    prods: torch.Tensor,
    acc_bits: int,
    policy: str = "clip",
    k_tile: int = 256,
    rounds: int = 2,
) -> torch.Tensor:
    """Accumulate partial products (last axis) under a policy (int32):

      wide             exact sum (no register)
      clip / wrap      natural order, saturating / wrapping adds
      sorted           ``rounds`` whole-axis sorting rounds, then clip
      sorted_tiled     per-tile sort + tile pairing, then clip
      sorted_tiled_seq per-tile sort, tiles in order, then clip
    """
    if policy == "wide":
        return prods.sum(dim=-1, dtype=torch.int32)
    if policy == "clip":
        return monotone_accumulate(prods, acc_bits, saturate=True)[0]
    if policy == "wrap":
        return monotone_accumulate(prods, acc_bits, saturate=False)[0]
    if policy == "sorted":
        ordered = sorted_order(prods, rounds)
    elif policy == "sorted_tiled":
        ordered = tiled_sorted_order(prods, k_tile, rounds)
    elif policy == "sorted_tiled_seq":
        ordered = tiled_seq_order(prods, k_tile, rounds)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return monotone_accumulate(ordered, acc_bits, saturate=True)[0]
