"""Narrow-accumulator simulation and the overflow census, torch port of
``repro.core.overflow``: explicit partial products (dense and N:M
kept-only), the accumulation policies, the census of persistent and
transient overflows, and the quantized-matmul simulation.

Every running sum is int32 and wraps as JAX's does: ``torch.cumsum`` and
``torch.sum`` of int32 return int64 unless told otherwise, so each one
here passes ``dtype=torch.int32``. The K-sharded accumulation
(``kshard_partials``/``kshard_accumulate``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quant import qrange
from repro_torch.core.sorted_accum import (
    monotone_accumulate,
    sorted_order,
    tiled_seq_order,
    tiled_sorted_order,
)


class Census(NamedTuple):
    """Overflow counts over a batch of dot products (int tensors)."""

    n_dots: torch.Tensor  # total dot products examined
    n_persistent: torch.Tensor  # final result out of range
    n_transient: torch.Tensor  # intermediate out of range, final in range
    n_any: torch.Tensor  # dots with any overflow event
    n_combine: torch.Tensor | int = 0  # K-sharded combine steps (unported)


def partial_products(wq: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """wq (out, K), xq (batch, K) -> (batch, out, K) int32 products."""
    return wq.to(torch.int32)[None, :, :] * xq.to(torch.int32)[:, None, :]


def nm_partial_products(values: torch.Tensor, indices: torch.Tensor,
                        xq: torch.Tensor, m_group: int) -> torch.Tensor:
    """Kept-only partial products of an N:M-compressed matmul: values and
    indices (N, G, n_keep), xq (batch, K) with K <= G * m_group (a shorter
    x is zero-extended) -> (batch, N, G*n_keep) int32, product j of group
    g being xq[i, g*m_group + indices[o, g, j]] * values[o, g, j]: the
    nonzero subsequence of the dense ``partial_products`` in ascending K
    on canonical slabs, so a census over it equals the dense census."""
    n, g, n_keep = values.shape
    x = xq.to(torch.int32)
    if x.shape[-1] < g * m_group:
        x = torch.nn.functional.pad(x, (0, g * m_group - x.shape[-1]))
    base = torch.arange(g, device=indices.device, dtype=torch.int64) * m_group
    pos = (indices.to(torch.int64) + base[:, None]).reshape(n, g * n_keep)
    return x[:, pos] * values.reshape(n, g * n_keep).to(torch.int32)


def _out_of_range(run: torch.Tensor, acc_bits: int) -> torch.Tensor:
    qmin, qmax = qrange(acc_bits)
    return (run > qmax) | (run < qmin)


def census(prods: torch.Tensor, acc_bits: int) -> Census:
    """Classify overflows of natural-order accumulation (paper Fig 2a):
    prods (..., K) int32, the running sum in index order. A persistent
    overflow is also an event of the running sum, so the transients are
    the events less the persistent ones. Every count stays on the
    device."""
    run = torch.cumsum(prods, dim=-1, dtype=torch.int32)
    qmin, qmax = qrange(acc_bits)
    lo, hi = torch.aminmax(run, dim=-1)  # one pass over the running sums
    n_any = ((hi > qmax) | (lo < qmin)).sum(dtype=torch.int32)
    n_persistent = _out_of_range(run[..., -1], acc_bits).sum(
        dtype=torch.int32)
    dev = prods.device
    return Census(
        n_dots=torch.full((), prods[..., 0].numel(), dtype=torch.int32,
                          device=dev),
        n_persistent=n_persistent,
        n_transient=n_any - n_persistent,
        n_any=n_any,
        n_combine=torch.zeros((), dtype=torch.int32, device=dev),
    )


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
    if policy == "natural":
        raise ValueError(f"unknown policy {policy!r}")
    return monotone_accumulate(policy_order(prods, policy, k_tile, rounds),
                               acc_bits, saturate=True)[0]


def policy_order(prods: torch.Tensor, policy: str, k_tile: int,
                 rounds: int) -> torch.Tensor:
    """The order a sorting policy (or ``natural``) adds the products in."""
    if policy == "sorted":
        return sorted_order(prods, rounds)
    if policy == "sorted_tiled":
        return tiled_sorted_order(prods, k_tile, rounds)
    if policy == "sorted_tiled_seq":
        return tiled_seq_order(prods, k_tile, rounds)
    if policy == "natural":
        return prods
    raise ValueError(f"unknown policy {policy!r}")


def transient_survivors(
    prods: torch.Tensor,
    acc_bits: int,
    policy: str = "sorted",
    k_tile: int = 256,
    rounds: int = 2,
) -> torch.Tensor:
    """Count (int32) the dot products whose exact result fits acc_bits
    but whose running sum in ``policy``'s order (``sorted``,
    ``sorted_tiled``, ``sorted_tiled_seq`` or ``natural``) still leaves
    the range: the transients a policy fails to fix (paper sections 3.2,
    6)."""
    final = prods.sum(dim=-1, dtype=torch.int32)
    fits = ~_out_of_range(final, acc_bits)
    run = torch.cumsum(policy_order(prods, policy, k_tile, rounds), dim=-1,
                       dtype=torch.int32)
    ovf = _out_of_range(run, acc_bits).any(dim=-1)
    return (fits & ovf).sum(dtype=torch.int32)


def quantized_matmul_sim(
    wq: torch.Tensor,
    xq: torch.Tensor,
    acc_bits: int,
    policy: str = "clip",
    k_tile: int = 256,
    batch_chunk: int | None = None,
    rounds: int = 2,
) -> torch.Tensor:
    """wq (out, K), xq (batch, K) -> (batch, out) int32, each output
    accumulated under ``policy``: ``pqs_dot`` on the plain (``torch``)
    backend, in the analysis tooling's (weights, activations) order."""
    # dispatch reaches this module through the kernels: import at call
    from repro_torch.core.dispatch import pqs_dot

    return pqs_dot(xq, wq, acc_bits=acc_bits, policy=policy, k_tile=k_tile,
                   rounds=rounds, backend="torch", batch_chunk=batch_chunk)


def matmul_census(wq: torch.Tensor, xq: torch.Tensor, acc_bits: int,
                  batch_chunk: int = 128) -> Census:
    """Census over every dot product of a quantized matmul (Fig 2a data),
    ``batch_chunk`` rows of x at a time; host int64 totals."""
    tot = dict(n_dots=0, n_persistent=0, n_transient=0, n_any=0)
    for i in range(0, xq.shape[0], batch_chunk):
        c = census(partial_products(wq, xq[i : i + batch_chunk]), acc_bits)
        for k in tot:
            tot[k] += int(getattr(c, k))
    return Census(**{k: torch.tensor(v) for k, v in tot.items()})
