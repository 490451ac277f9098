"""Padding and routing around the port's kernels, torch port of
``repro.kernels.ops`` for the K-streaming policies.

``policy_matmul`` pads K by the policy's rule (``padded_k``) and routes
the K-streaming policies to ``sorted_matmul.seq_policy_matmul``. The
global-sort policies have no CUDA kernel yet: on CPU tensors they run the
plain version, on CUDA tensors they raise. The TPU block table, its
environment overrides and the autotuner are not carried over — their
numbers were VMEM budgets of the TPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sorted_matmul import (
    SEQ_POLICIES,
    SORT_POLICIES,
    policy_accumulate_ref,
    seq_policy_matmul,
)

POLICIES = SEQ_POLICIES + SORT_POLICIES


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]  # last axis first
    return torch.nn.functional.pad(x, widths)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def padded_k(k: int, policy: str, k_tile: int) -> int:
    """The K length a policy accumulates over: a power of two for
    ``sorted``, whole k_tile tiles for the tiled policies, else K."""
    if policy == "sorted":
        return next_pow2(k)
    if policy in ("sorted_tiled", "sorted_tiled_seq"):
        return k + ((-k) % k_tile)
    return k


def policy_matmul(
    x: torch.Tensor,  # (M, K) integer carrier
    w: torch.Tensor,  # (N, K) integer carrier
    *,
    policy: str = "wide",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    census: bool = True,
) -> torch.Tensor:
    """(M, N) int32 under any accumulation policy, any shape.

    ``census=False`` is the certified route: a proof says no partial sum
    reaches the acc_bits caps, so the request is served by the exact
    ``wide`` body.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
    if not census:
        policy = "wide"  # provably saturate-free -> exact wide body
    kp = padded_k(x.shape[1], policy, k_tile)
    xp = _pad_to(x, kp, 1)
    wp = _pad_to(w, kp, 1)
    if policy in SORT_POLICIES:
        if xp.is_cuda:
            raise NotImplementedError(
                f"policy {policy!r} needs the global-sort kernels "
                "(sort_matmul and the two-pass sorted_stream pipeline), "
                "which a later slice of the port brings to CUDA; use "
                "backend='torch' for the plain version"
            )
        return policy_accumulate_ref(xp, wp, policy=policy,
                                     acc_bits=acc_bits, k_tile=k_tile,
                                     rounds=rounds)
    return seq_policy_matmul(xp, wp, policy=policy, acc_bits=acc_bits,
                             rounds=rounds, k_tile=k_tile)
