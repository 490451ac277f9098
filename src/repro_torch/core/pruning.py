"""N:M semi-structured pruning (paper section 2.2), the compressed
storage format, and the filter-pruning and low-rank baselines (paper
Figs 3-4), torch port of ``repro.core.pruning``.

Compressed form of an (..., rows, K) matrix with at most n_keep nonzeros
in every m-group along K:

    values  (..., rows, G, n_keep)  kept weights, G = ceil(K / m)
    indices (..., rows, G, n_keep)  int32 position of each inside its group

Canonical form (made by ``nm_compress``, relied on by the gather kernel,
re-checked on demand by ``nm_assert_canonical``): indices lie in [0, m)
and ascend within each group, and a slot whose dense position holds no
kept weight (group padding, tail positions past K) carries value 0.

Compressed-to-dense is ``nm_decompress``, a ``scatter_add_``. The JAX
package's one-hot einsum (``nm_onehot_expand``) is not carried over: for
the tied qwen2-1.5b embedding it would build a (1536, 9496, 8, 16)
one-hot, about 7.5 GB. The scatter-add is exact for the reason the
one-hot sum is: a canonical group holds each position at most once with
a nonzero value, and a padded (value 0) slot adds nothing, even where it
shares index 0 with a kept value.
"""

from __future__ import annotations

from typing import Optional

import torch


def nm_prune_mask(w: torch.Tensor, n_keep: int, m: int) -> torch.Tensor:
    """Binary mask keeping the ``n_keep`` largest-|w| of every ``m`` along
    the last axis. Ties go to the lower index: both argsorts are stable,
    as ``jnp.argsort`` is, so tied magnitudes keep the same survivors."""
    if w.shape[-1] % m != 0:
        raise ValueError(f"last dim {w.shape[-1]} not divisible by M={m}")
    if not (0 <= n_keep <= m):
        raise ValueError(f"n_keep={n_keep} out of range for M={m}")
    groups = w.reshape(*w.shape[:-1], w.shape[-1] // m, m)
    mag = groups.abs()
    order = torch.argsort(-mag, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)  # 0 = largest
    mask = (ranks < n_keep).to(w.dtype)
    return mask.reshape(w.shape)


def sparsity(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros in a mask or tensor (float32)."""
    return 1.0 - (mask != 0).to(torch.float32).mean()


def iterative_nm_schedule(total_epochs: int, prune_every: int, m: int,
                          target_sparsity: float) -> list[tuple[int, int]]:
    """Paper section 5.0.2: every ``prune_every`` epochs prune about 10 %
    more of each m-group, the last step jumping to the target. Returns
    [(epoch, n_keep), ...]; e.g. m = 16 at 30 %: epochs 10/20/30 keep
    14/13/11."""
    steps = []
    spars = 0.0
    epoch = prune_every
    while spars + 1e-9 < target_sparsity and epoch <= total_epochs:
        spars = min(spars + 0.10, target_sparsity)
        if epoch + prune_every > total_epochs:
            spars = target_sparsity  # last chance: jump to target
        steps.append((epoch, max(int(round(m * (1.0 - spars))), 0)))
        epoch += prune_every
    return steps


def filter_prune_mask(w: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """Structured filter pruning baseline (paper Fig 4): zero the whole
    output rows (filters) of w (out, in...) with the smallest L2 norms,
    keeping round(out * keep_frac) of them (at least one; rows tied with
    the threshold norm stay)."""
    norms = torch.linalg.vector_norm(w.reshape(w.shape[0], -1), dim=1)
    k = max(int(round(w.shape[0] * keep_frac)), 1)
    thresh = torch.sort(norms).values[-k]
    rows = (norms >= thresh).to(w.dtype)
    return rows.reshape((-1,) + (1,) * (w.ndim - 1)) * torch.ones_like(w)


def low_rank_approx(w: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank-k SVD approximation of a 2-D weight matrix (paper Fig 3)."""
    u, s, vh = torch.linalg.svd(w, full_matrices=False)
    k = min(rank, s.shape[0])
    return (u[:, :k] * s[:k]) @ vh[:k, :]


def _check_nm_args(k: int, n_keep: int, m: int) -> None:
    if m < 1:
        raise ValueError(f"m_group must be >= 1, got {m}")
    if not 1 <= n_keep <= m:
        raise ValueError(f"n_keep={n_keep} out of range [1, {m}] for M={m}")
    if k < 1:
        raise ValueError(f"cannot compress an empty K axis (K={k})")


def nm_compress(w: torch.Tensor, n_keep: int, m: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack an N:M-pruned (..., rows, K) matrix into (values, indices),
    each (..., rows, G, n_keep) with G = ceil(K / m); the tail group is
    zero-padded. Covers both ``nm_compress`` and ``nm_compress_jax`` of
    the JAX package, with the same survivors: the n_keep largest |w| of
    each group by a stable sort (ties to the lower position), stored in
    ascending position. A group holding more than n_keep nonzeros would
    compress lossily, so it raises."""
    if w.ndim < 2:
        raise ValueError(f"expected a (..., rows, K) matrix, got "
                         f"{tuple(w.shape)}")
    k = w.shape[-1]
    _check_nm_args(k, n_keep, m)
    g = -(-k // m)
    if g * m != k:
        w = torch.nn.functional.pad(w, (0, g * m - k))
    grouped = w.reshape(*w.shape[:-1], g, m)
    if grouped.numel():
        nnz = int((grouped != 0).sum(dim=-1).max())
        if nnz > n_keep:
            raise ValueError(
                f"matrix is not {n_keep}:{m} sparse — a group holds {nnz} "
                f"nonzeros (> n_keep={n_keep}); compressing it would "
                "silently drop weights")
    # magnitudes in int32 for integer codes: |-128| does not fit int8
    mag = grouped.abs() if grouped.is_floating_point() else \
        grouped.to(torch.int32).abs()
    order = torch.argsort(-mag, dim=-1, stable=True)[..., :n_keep]
    order = torch.sort(order, dim=-1).values  # ascending position
    vals = torch.gather(grouped, -1, order)
    return vals, order.to(torch.int32)


def nm_decompress(vals: torch.Tensor, idx: torch.Tensor, m: int,
                  k: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``nm_compress``: (..., G, n_keep) -> dense (..., G*m) in
    the dtype of ``vals``, trimmed to ``k`` columns when given."""
    if vals.shape != idx.shape or vals.ndim < 2:
        raise ValueError(f"expected matching (..., G, n_keep) slabs, got "
                         f"{tuple(vals.shape)} vs {tuple(idx.shape)}")
    g = vals.shape[-2]
    dense = torch.zeros((*vals.shape[:-1], m), dtype=vals.dtype,
                        device=vals.device)
    dense.scatter_add_(-1, idx.to(torch.int64), vals)
    dense = dense.reshape(*vals.shape[:-2], g * m)
    return dense if k is None else dense[..., :k]


def nm_assert_canonical(vals: torch.Tensor, idx: torch.Tensor, m: int,
                        k: Optional[int] = None) -> None:
    """Raise AssertionError unless a slab is in canonical form: indices in
    [0, m), ascending within each group (a repeated index only on a value-0
    slot), and, with ``k``, value 0 at every dense position >= k. For tests
    and for slabs packed elsewhere; never called per kernel launch."""
    if vals.shape != idx.shape or vals.ndim < 2:
        raise ValueError(f"expected matching (..., G, n_keep) slabs, got "
                         f"{tuple(vals.shape)} vs {tuple(idx.shape)}")
    g = vals.shape[-2]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= m):
        raise AssertionError(f"indices out of range [0, {m}): "
                             f"[{int(idx.min())}, {int(idx.max())}]")
    if idx.shape[-1] > 1:
        d = torch.diff(idx.to(torch.int64), dim=-1)
        dup = (d == 0) & (vals[..., 1:] != 0)
        if bool((d < 0).any()) or bool(dup.any()):
            raise AssertionError("indices must ascend within each group "
                                 "(padded slots carry value 0)")
    if k is not None:
        if not 0 < k <= g * m:
            raise ValueError(f"k={k} out of range (0, {g * m}]")
        base = torch.arange(g, device=idx.device, dtype=torch.int64) * m
        dense_pos = idx.to(torch.int64) + base[:, None]
        if bool((vals[dense_pos >= k] != 0).any()):
            raise AssertionError(
                f"tail positions >= k={k} must carry value 0 (the "
                "ragged-tail zero-pad invariant)")
