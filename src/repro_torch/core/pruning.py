"""N:M semi-structured pruning (paper section 2.2), torch port of
``repro.core.pruning.nm_prune_mask``. Compression and the schedules are
not ported yet."""

from __future__ import annotations

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
