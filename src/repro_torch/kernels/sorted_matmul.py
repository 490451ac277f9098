"""PQS accumulation-policy matmul for Hopper: ``seq_policy_matmul``.

Port of ``repro/kernels/sorted_matmul.py:seq_policy_matmul``. Computes
Z = X Wᵀ for int8 X (M, K) and W (N, K) into an (M, N) int32 carrier that
holds an ``acc_bits``-bit register under a K-streaming policy:

  wide             exact int32 dot
  clip             natural K order, saturating add at every step
  wrap             natural K order, two's-complement wrap at acc_bits
  sorted_tiled_seq per-k_tile split/sort/pair rounds, then saturating
                   adds; tiles in natural order (paper section 6)

``seq_policy_matmul`` launches the hand-written CUDA kernel
(``csrc/seq_policy_matmul.cu``, whose header says how it is built and
what bounds it) on CUDA tensors, and takes the plain version
``seq_policy_matmul_ref`` only for tensors on the CPU. Each launch adds
one to ``seq_policy_matmul.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.overflow import accumulate, partial_products

SEQ_POLICIES = ("wide", "clip", "wrap", "sorted_tiled_seq")
SORT_POLICIES = ("sorted", "sorted_tiled")
# k_tile values the kernel is instantiated for (csrc switch)
KERNEL_K_TILES = tuple(1 << i for i in range(11))
# elements of the (rows, N, K) int32 product tensor one plain-version
# chunk may hold (1 GiB); rows are chunked to stay under it
PRODUCT_BUDGET = 1 << 28


def row_chunk(n: int, k: int) -> int:
    """Rows per plain-version chunk for an (N, K) weight."""
    return max(1, PRODUCT_BUDGET // max(n * k, 1))


def policy_accumulate_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    policy: str,
    acc_bits: int,
    k_tile: int,
    rounds: int,
    batch_chunk: int | None = None,
) -> torch.Tensor:
    """Plain version of any policy on (M, K) x (N, K): explicit partial
    products, chunked over M, through ``overflow.accumulate``. The caller
    pads K as the policy needs."""
    m, n = x.shape[0], w.shape[0]
    chunk = batch_chunk or row_chunk(n, x.shape[1])
    outs = [
        accumulate(partial_products(w, x[i : i + chunk]), acc_bits, policy,
                   k_tile, rounds)
        for i in range(0, m, chunk)
    ]
    if not outs:
        return torch.zeros((0, n), dtype=torch.int32, device=x.device)
    return torch.cat(outs, dim=0)


def seq_policy_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    policy: str = "clip",
    acc_bits: int = 16,
    rounds: int = 1,
    k_tile: int = 256,
) -> torch.Tensor:
    """Plain PyTorch version of ``seq_policy_matmul`` (any device)."""
    if policy not in SEQ_POLICIES:
        raise ValueError(f"unknown seq policy {policy!r}; {SEQ_POLICIES}")
    k = x.shape[1]
    if policy == "sorted_tiled_seq" and k % k_tile:
        pad = k_tile - k % k_tile  # zero products are inert
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    return policy_accumulate_ref(x, w, policy=policy, acc_bits=acc_bits,
                                 k_tile=k_tile, rounds=rounds)


def _as_int8(a: torch.Tensor, what: str) -> torch.Tensor:
    if a.dtype == torch.int8:
        return a
    if a.dtype != torch.int32:
        raise TypeError(f"{what} must be int8 or an int32 carrier of int8 "
                        f"values, got {a.dtype}")
    if a.numel() and (int(a.min()) < -128 or int(a.max()) > 127):
        raise ValueError(f"{what}: int32 carrier holds values outside int8")
    return a.to(torch.int8)


def _lib():
    from repro_torch.kernels import build

    lib = build.library("seq_policy_matmul")
    fn = lib.pqs_seq_policy_matmul
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    return fn


def seq_policy_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    w: torch.Tensor,  # (N, K) weights, rows = output channels
    *,
    policy: str = "clip",
    acc_bits: int = 16,
    rounds: int = 1,
    k_tile: int = 256,
) -> torch.Tensor:
    """(M, N) int32 under a K-streaming policy: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. Any M, N, K: the kernel
    masks the edges itself (zero products are inert under every policy).
    For sorted_tiled_seq, ``k_tile`` is the sort tile (a power of two)."""
    if policy not in SEQ_POLICIES:
        raise ValueError(f"unknown seq policy {policy!r}; {SEQ_POLICIES}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not 2 <= acc_bits <= 30:
        raise ValueError(f"acc_bits={acc_bits} outside [2, 30]")
    if policy == "sorted_tiled_seq" and (k_tile <= 0 or k_tile & (k_tile - 1)):
        raise ValueError(f"k_tile must be a power of 2, got {k_tile}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return seq_policy_matmul_ref(x, w, policy=policy, acc_bits=acc_bits,
                                     rounds=rounds, k_tile=k_tile)
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"x and w must share one CUDA device, got "
                         f"{x.device} and {w.device}")
    if policy == "sorted_tiled_seq" and k_tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel sorts tiles of up to {KERNEL_K_TILES[-1]} "
            f"products; k_tile={k_tile}")
    x8, w8 = _as_int8(x, "x"), _as_int8(w, "w")
    if not (x8.is_contiguous() and w8.is_contiguous()):
        raise ValueError("seq_policy_matmul needs contiguous operands")
    m, k = x8.shape
    n = w8.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=x8.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x8.device).cuda_stream
    err = _lib()(x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k,
                 SEQ_POLICIES.index(policy), acc_bits, rounds, k_tile, stream)
    if err != 0:
        raise RuntimeError(f"seq_policy_matmul launch failed: CUDA error {err}")
    seq_policy_matmul.launches += 1
    return out


seq_policy_matmul.launches = 0
