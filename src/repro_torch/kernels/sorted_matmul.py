"""PQS accumulation-policy matmuls for Hopper: ``seq_policy_matmul`` and
``sort_matmul``.

Port of ``repro/kernels/sorted_matmul.py``. Both compute Z = X Wᵀ for int8
X (M, K) and W (N, K) into an (M, N) int32 carrier that holds an
``acc_bits``-bit register. ``seq_policy_matmul`` runs a K-streaming
policy:

  wide             exact int32 dot
  clip             natural K order, saturating add at every step
  wrap             natural K order, two's-complement wrap at acc_bits
  sorted_tiled_seq per-k_tile split/sort/pair rounds, then saturating
                   adds; tiles in natural order (paper section 6)

``sort_matmul`` a global-sort policy, with the whole K of each output at
hand (the one-pass kernel):

  sorted           split/sort/pair rounds over the whole K (a power of 2)
  sorted_tiled     per-tile rounds, then tiles paired by their sums and
                   element-interleaved (the paper's two-level sort)

Each wrapper launches its hand-written CUDA kernel
(``csrc/seq_policy_matmul.cu``, ``wide`` on the int8 tensor-core mainloop
of ``csrc/int8_mma.cuh``; ``csrc/sort_matmul.cu``; their headers say how
they are built and what bounds them) on CUDA tensors, and takes its
plain version (``*_ref``) only for tensors on the CPU. Each launch adds
one to the wrapper's ``.launches`` (and, for ``seq_policy_matmul``, to
``.policy_launches`` under its policy).
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


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def on_cpu(*tensors) -> bool:
    """Whether every tensor lies on the CPU (the wrappers then take their
    plain versions)."""
    return all(t.device.type == "cpu" for t in tensors)


def padded_k(k: int, policy: str, k_tile: int) -> int:
    """The K length a policy accumulates over: a power of two for
    ``sorted``, whole k_tile tiles for the tiled policies, else K."""
    if policy == "sorted":
        return next_pow2(k)
    if policy in ("sorted_tiled", "sorted_tiled_seq"):
        return k + ((-k) % k_tile)
    return k


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
    """Narrow an int32 carrier to the int8 the kernels read. Carriers hold
    int8 values by the ``pqs_dot`` contract; a value outside int8 raises
    rather than wrap (one reduction, and a wait for the device, only when
    the carrier is not int8 already)."""
    if a.dtype == torch.int8:
        return a
    if a.dtype != torch.int32:
        raise TypeError(f"{what} must be int8 or an int32 carrier of int8 "
                        f"values, got {a.dtype}")
    if a.numel():
        lo, hi = int(a.min()), int(a.max())
        if lo < -128 or hi > 127:
            raise ValueError(f"{what}: carriers must hold int8 values "
                             f"(pqs_dot contract); got range [{lo}, {hi}]")
    return a.to(torch.int8)


def lib_fn(source: str, name: str, n_ptrs: int, n_ints: int):
    """The C function ``name`` of ``csrc/<source>.cu`` (built at first
    use): ``n_ptrs`` pointers, ``n_ints`` ints, then the stream; it
    returns a CUDA error code."""
    from repro_torch.kernels import build

    fn = getattr(build.library(source), name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
    return fn


def card_operands(what: str, x: torch.Tensor, w: torch.Tensor):
    """x and w as contiguous int8 on one CUDA device; raises on anything
    else (the kernels take int8 values, int8 or an int32 carrier)."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"x and w must share one CUDA device, got "
                         f"{x.device} and {w.device}")
    x8, w8 = _as_int8(x, "x"), _as_int8(w, "w")
    if not (x8.is_contiguous() and w8.is_contiguous()):
        raise ValueError(f"{what} needs contiguous operands")
    return x8, w8


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    if policy == "sorted_tiled_seq" and k_tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel sorts tiles of up to {KERNEL_K_TILES[-1]} "
            f"products; k_tile={k_tile}")
    x8, w8 = card_operands("seq_policy_matmul", x, w)
    m, k = x8.shape
    n = w8.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=x8.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    fn = lib_fn("seq_policy_matmul", "pqs_seq_policy_matmul", 3, 7)
    err = fn(x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k,
             SEQ_POLICIES.index(policy), acc_bits, rounds, k_tile,
             stream_of(x8))
    if err != 0:
        raise RuntimeError(f"seq_policy_matmul launch failed: CUDA error {err}")
    seq_policy_matmul.launches += 1
    seq_policy_matmul.policy_launches[policy] += 1
    return out


seq_policy_matmul.launches = 0
seq_policy_matmul.policy_launches = dict.fromkeys(SEQ_POLICIES, 0)


def _check_sort(x, w, policy, acc_bits, k_tile, kp=None) -> int:
    """The global-sort kernels' contract (as the JAX kernels assert it),
    on ``kp``, the K the policy accumulates over: a power of two for
    ``sorted``, whole power-of-two k_tile tiles for ``sorted_tiled``.
    ``kp`` defaults to the operands' K; a larger one extends their rows
    with zero products (the card kernels mask them, the plain versions
    pad). Returns kp."""
    if policy not in SORT_POLICIES:
        raise ValueError(f"unknown sort policy {policy!r}; {SORT_POLICIES}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not 2 <= acc_bits <= 30:
        raise ValueError(f"acc_bits={acc_bits} outside [2, 30]")
    k = x.shape[1]
    kp = k if kp is None else kp
    if kp < k:
        raise ValueError(f"kp={kp} below the operands' K={k}")
    if policy == "sorted" and (kp <= 0 or kp & (kp - 1)):
        raise ValueError(f"sorted needs K a power of 2, got {kp}")
    if policy == "sorted_tiled" and (
            k_tile <= 0 or k_tile & (k_tile - 1) or kp % k_tile):
        raise ValueError(f"sorted_tiled needs a power-of-2 k_tile dividing "
                         f"K, got K={kp}, k_tile={k_tile}")
    return kp


def pad_k(a: torch.Tensor, kp: int) -> torch.Tensor:
    """Zero-extend the rows of ``a`` to ``kp`` columns (plain versions)."""
    return torch.nn.functional.pad(a, (0, kp - a.shape[1]))


def sort_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    kp: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``sort_matmul`` (any device)."""
    kp = _check_sort(x, w, policy, acc_bits, k_tile, kp)
    return policy_accumulate_ref(pad_k(x, kp), pad_k(w, kp), policy=policy,
                                 acc_bits=acc_bits, k_tile=k_tile,
                                 rounds=rounds)


# shared memory of the one-pass kernels: for sorted 2 bytes a key (the
# cross-warp exchange of the keys held in registers, 4 bytes a packed
# int16x2 position; the expand twin's expanded keys), for sorted_tiled two
# int32 per tile; a block may use 227 KB
SORT_SMEM_BYTES = 128 * 1024
# the longest K the `sorted` kernel holds (int16 keys, 16 warps of 64 packed
# positions a lane); chunked_sort_matmul (the two-pass route of `sorted`)
# runs the same kernel to this K
SORTED_MAX_K = SORT_SMEM_BYTES // 2


def check_sort_smem(policy, kp, k_tile, keys=None, tile=None, row=0
                    ) -> None:
    """Refuse (NotImplementedError) what the one-pass global-sort kernels
    cannot hold: 2 bytes of shared memory for each of the ``keys`` int16
    keys of ``sorted`` (default kp) or two int32 per k_tile tile of
    ``sorted_tiled``, with ``row`` bytes beside them (an expanded N:M
    row), above ``SORT_SMEM_BYTES``, or a sort tile (default k_tile) no
    kernel instance covers."""
    keys = kp if keys is None else keys
    tile = k_tile if tile is None else tile
    smem = (2 * keys if policy == "sorted" else 8 * (kp // k_tile)) + row
    if smem > SORT_SMEM_BYTES:
        raise NotImplementedError(
            f"the CUDA kernel needs {smem} bytes of shared memory for its "
            f"keys, above {SORT_SMEM_BYTES}: K={kp}"
            + (f" (at most {SORTED_MAX_K} for sorted)"
               if policy == "sorted" else ""))
    if policy == "sorted_tiled" and tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel sorts tiles of up to {KERNEL_K_TILES[-1]} "
            f"products; k_tile={k_tile}")


def launch_sort(what, x, w, kp, policy, acc_bits, k_tile, rounds):
    """Launch ``pqs_sort_matmul`` (csrc/sort_matmul.cu) on CUDA tensors;
    (M, N) int32. The caller counts the launch."""
    check_sort_smem(policy, kp, k_tile)
    x8, w8 = card_operands(what, x, w)
    m, k = x8.shape
    n = w8.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=x8.device)
    if m == 0 or n == 0:
        return out
    fn = lib_fn("sort_matmul", "pqs_sort_matmul", 3, 8)
    err = fn(x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k, kp,
             SORT_POLICIES.index(policy), acc_bits, rounds, k_tile,
             stream_of(x8))
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    return out


def sort_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    w: torch.Tensor,  # (N, K), rows = output channels
    *,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    kp: int | None = None,
) -> torch.Tensor:
    """(M, N) int32 under ``sorted`` (over kp, a power of two) or
    ``sorted_tiled`` (kp a multiple of the power-of-two k_tile), the whole
    K of each output at once: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. ``kp`` (default K) is the policy's padded K:
    the columns past K are zero products, so callers need not pad."""
    kp = _check_sort(x, w, policy, acc_bits, k_tile, kp)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return sort_matmul_ref(x, w, policy=policy, acc_bits=acc_bits,
                               k_tile=k_tile, rounds=rounds, kp=kp)
    out = launch_sort("sort_matmul", x, w, kp, policy, acc_bits, k_tile,
                      rounds)
    if out.numel():
        sort_matmul.launches += 1
    return out


sort_matmul.launches = 0
