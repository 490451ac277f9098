"""Sorted dot product (paper Algorithm 1) and its tiled variants, torch port
of ``repro.core.sorted_accum``.

All functions act on the partial-products array (int32 carrier) along the
last axis, with any leading batch dims. Shapes are fixed: the shrinking
arrays of the paper's pseudo-code are zero-padded, and zeros are
sign-neutral and additively inert, so the fixed-shape form is exact.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import qrange

_NEG_INF = torch.iinfo(torch.int32).min
_POS_INF = torch.iinfo(torch.int32).max


def pairwise_round(prods: torch.Tensor) -> torch.Tensor:
    """One round of split / sort / pairwise-add (Alg. 1 body), fixed shape.

    out[i] = pos_sorted[i] + neg_sorted[i], positives descending and
    negatives ascending, each 0-padded past its count.
    """
    # Positives descending: the INT32_MIN sentinel sorts first ascending,
    # the flip puts it last. Never negate a sentinel: -INT32_MIN wraps.
    pos = torch.where(prods > 0, prods, _NEG_INF)
    pos = torch.flip(torch.sort(pos, dim=-1).values, dims=(-1,))
    pos = torch.where(pos == _NEG_INF, 0, pos)
    # Negatives ascending: the INT32_MAX sentinel pushes the rest back.
    neg = torch.where(prods < 0, prods, _POS_INF)
    neg = torch.sort(neg, dim=-1).values
    neg = torch.where(neg == _POS_INF, 0, neg)
    return pos + neg


def alg1_sorted_dot(prods: torch.Tensor, max_rounds: int | None = None
                    ) -> torch.Tensor:
    """The paper's multi-round Algorithm 1: the exact dot (int32 sum).

    Rounds repeat while both signs are present, up to ceil(log2 K) + 1
    (each round at least halves the mixed-sign values). The predicate is
    global over the whole batch, as the JAX package's ``jnp.any`` with no
    axis: every dot takes a round while any dot still holds both signs.
    """
    k = prods.shape[-1]
    if max_rounds is None:
        max_rounds = max(k.bit_length(), 1)
    out = prods
    for _ in range(max_rounds):
        if bool((out > 0).any()) and bool((out < 0).any()):
            out = pairwise_round(out)
    return out.sum(dim=-1, dtype=torch.int32)


def sorted_order(prods: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """Accumulation-ready array after ``rounds`` sorting rounds."""
    out = prods
    for _ in range(rounds):
        out = pairwise_round(out)
    return out


def sorted_single_round_order(prods: torch.Tensor) -> torch.Tensor:
    """One-round variant (the paper's 'single sorting round' claim)."""
    return sorted_order(prods, rounds=1)


def monotone_accumulate(
    vals: torch.Tensor, acc_bits: int, saturate: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequentially accumulate ``vals`` (last axis) into a p-bit register.

    Returns (result, overflowed): one clip (``saturate``) or one floor-mod
    wrap per add, and whether any partial sum left the range.
    """
    qmin, qmax = qrange(acc_bits)
    # int32 carrier: exact while 16-bit products summed K times stay below
    # 2^31 (K <= 2^17 for int8 operands) and acc_bits <= 30.
    if acc_bits > 30:
        raise ValueError("acc_bits > 30 would overflow the int32 carrier")
    span = 2**acc_bits
    moved = torch.movedim(vals.to(torch.int32), -1, 0).contiguous()
    acc = torch.zeros(moved.shape[1:], dtype=torch.int32, device=vals.device)
    ovf = torch.zeros(moved.shape[1:], dtype=torch.bool, device=vals.device)
    for t in range(moved.shape[0]):
        nxt = acc + moved[t]
        ovf = ovf | (nxt > qmax) | (nxt < qmin)
        if saturate:
            acc = torch.clamp(nxt, qmin, qmax)
        else:
            # floor mod, as jnp.mod: the result takes the divisor's sign
            acc = torch.remainder(nxt - qmin, span) + qmin
    return acc, ovf


def pair_permutation(sums: torch.Tensor) -> torch.Tensor:
    """Rank-and-interleave tile pairing from per-tile net sums: positives-
    descending ranks in even slots, ascending ranks in odd slots. Ties
    break as the stable ``jnp.argsort`` does."""
    n_tiles = sums.shape[-1]
    asc = torch.argsort(sums, dim=-1, stable=True)
    desc = torch.flip(asc, dims=(-1,))
    half = (n_tiles + 1) // 2
    perm = torch.zeros_like(desc)
    perm[..., 0::2] = desc[..., :half]
    perm[..., 1::2] = asc[..., : n_tiles - half]
    return perm


def tiled_sorted_order(
    prods: torch.Tensor, k_tile: int, rounds: int = 2
) -> torch.Tensor:
    """Two-level tiled order (``sorted_tiled``): ``rounds`` of sorting in
    each k_tile tile, then tiles paired by net sum and element-interleaved;
    an odd tile goes last."""
    k = prods.shape[-1]
    if k % k_tile != 0:
        raise ValueError(f"K={k} not divisible by k_tile={k_tile}")
    n_tiles = k // k_tile
    tiles = prods.reshape(*prods.shape[:-1], n_tiles, k_tile)
    ordered = sorted_order(tiles, rounds)
    if n_tiles == 1:
        return ordered.reshape(prods.shape)
    perm = pair_permutation(ordered.sum(dim=-1, dtype=torch.int32))
    return paired_order(ordered, perm)


def paired_order(tiles: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(..., n_tiles, k_tile) tiles -> (..., n_tiles * k_tile) stream in
    the paired order ``perm`` (..., n_tiles) gives: tiles perm[2s] and
    perm[2s+1] element-interleaved (a0, b0, a1, b1, ...), an odd last
    tile perm[-1] appended."""
    n_tiles, k_tile = tiles.shape[-2:]
    idx = perm[..., None].expand(*perm.shape, k_tile)
    ordered = torch.gather(tiles, -2, idx)
    n_pairs = n_tiles // 2
    lead = ordered.shape[:-2]
    main = ordered[..., : 2 * n_pairs, :].reshape(*lead, n_pairs, 2, k_tile)
    main = main.transpose(-1, -2).reshape(*lead, n_pairs * 2 * k_tile)
    if n_tiles % 2:
        return torch.cat([main, ordered[..., -1, :]], dim=-1)
    return main


def tiled_pairwise_order(prods: torch.Tensor, k_tile: int) -> torch.Tensor:
    """The two-level tiled order at two rounds (the JAX package's
    back-compat alias)."""
    return tiled_sorted_order(prods, k_tile, rounds=2)


def tiled_seq_order(
    prods: torch.Tensor, k_tile: int, rounds: int = 1
) -> torch.Tensor:
    """Paper section 6 tiled sorting as a blocked kernel sees it: each
    K tile sorted and paired on its own, tiles kept in natural order."""
    k = prods.shape[-1]
    if k % k_tile != 0:
        raise ValueError(f"K={k} not divisible by k_tile={k_tile}")
    tiles = prods.reshape(*prods.shape[:-1], k // k_tile, k_tile)
    return sorted_order(tiles, rounds).reshape(prods.shape)
