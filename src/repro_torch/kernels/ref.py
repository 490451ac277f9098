"""The oracles of the kernels, torch port of ``repro.kernels.ref``: plain
PyTorch on any device, built on the port's ``core.sorted_accum`` so that
the kernels, the quickstart and the analysis tooling share one definition
of each policy's order and saturation points."""

from __future__ import annotations

import torch

from repro_torch.core.overflow import partial_products
from repro_torch.core.sorted_accum import (
    monotone_accumulate,
    sorted_order,
    tiled_seq_order,
)
from repro_torch.kernels import nm_spmm as _nm
from repro_torch.kernels import quant_matmul as _qm


def quant_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 wide accumulation."""
    return _qm.quant_matmul_ref(x, w)


def sorted_matmul_ref(x: torch.Tensor, w: torch.Tensor, acc_bits: int = 16,
                      rounds: int = 1, k_tile: int = 256) -> torch.Tensor:
    """Oracle of ``ops.sorted_matmul``: x (M, K), w (N, K), per-K-tile
    sorted pairs in natural tile order, stepwise saturation at acc_bits
    (K a multiple of k_tile)."""
    ordered = tiled_seq_order(partial_products(w, x), k_tile, rounds)
    return monotone_accumulate(ordered, acc_bits, saturate=True)[0]


def clip_matmul_ref(x: torch.Tensor, w: torch.Tensor, acc_bits: int = 16
                    ) -> torch.Tensor:
    """Oracle of ``ops.clip_matmul``: natural order, saturating adds."""
    return monotone_accumulate(partial_products(w, x), acc_bits,
                               saturate=True)[0]


def nm_spmm_ref(x: torch.Tensor, values: torch.Tensor,
                indices: torch.Tensor, m_group: int) -> torch.Tensor:
    """Oracle of ``ops.nm_spmm``: decompress (scatter-add), then the wide
    matmul."""
    return _nm.nm_spmm_ref(x, values, indices, m_group=m_group)


def sorted_dot_ref(prods: torch.Tensor, acc_bits: int, rounds: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-dot oracle: (value, overflowed) after sorting + saturation."""
    return monotone_accumulate(sorted_order(prods, rounds), acc_bits,
                               saturate=True)
