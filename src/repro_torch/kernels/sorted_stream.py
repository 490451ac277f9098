"""Two-pass global-sort pipeline for long K on Hopper, torch port of
``repro/kernels/sorted_stream.py``, on dense storage and on the kept
products of N:M compressed storage.

``sorted_tiled`` in two passes over K:

  pass 1  ``tile_sums_matmul``: the (M, N, K/k_tile) int32 sums of each
          output's k_tile tiles. Sorting never changes a tile's sum, so
          these raw-product sums are the ones the one-pass order ranks.
  pairing ``core.sorted_accum.pair_permutation`` over the sums, in plain
          torch between the kernels, as the JAX package runs it outside
          its kernels.
  pass 2  ``paired_accum_matmul``: each output's tiles in the paired
          order its row of perm gives, each tile sorted, each pair
          element-interleaved (a0, b0, a1, b1, ...), an odd last tile
          appended, one saturating add per product.

``sorted`` at long K (a power of two): ``chunked_sort_matmul``, one
split/sort/pair stage over the whole K of each output. On the card one
block holds all of an output's keys up to ``SORTED_MAX_K``, so it launches
the one-pass ``sorted`` kernel of ``csrc/sort_matmul.cu``, counted here.

On the card pass 1 runs on the int8 tensor-core mainloop of
``csrc/int8_mma.cuh`` (k_tile a power-of-two multiple of 64; shorter
tiles on a small-tile body, ``tile_sums_body``), and its gather and
expand twins on one body that reads each kept slot once for all rows of x
(``csrc/nm_tile_sums.cuh``; ``nm_tile_sums_body``,
``nm_expand_tile_sums_body``), which differ only in a slot whose index
lies outside its group: the gather reads x where it points, the expand
drops it.

``stream_sort_matmul`` is the entry point ``ops.policy_matmul`` routes K
above ``ops.MAX_RESIDENT_K`` to. On N:M compressed slabs the gather twins
``nm_gather_tile_sums``, ``nm_gather_paired_accum_matmul`` and
``nm_gather_chunked_sort_matmul`` (``csrc/nm_sort_matmul.cu``) form only
the kept products, a k_tile tile being its (k_tile/m_group) * n_keep kept
products; the expand twins ``nm_tile_sums_matmul``,
``nm_paired_accum_matmul`` and ``nm_chunked_sort_matmul``
(``csrc/nm_expand_sort.cu``) rebuild each row's dense positions from the
slabs in shared memory and run the dense bodies.
``nm_gather_stream_sort_matmul`` and ``nm_stream_sort_matmul`` are their
entry points, which ``ops.nm_policy_matmul`` routes to. Each kernel
wrapper launches its hand-written CUDA kernel (``csrc/sorted_stream.cu``,
``csrc/nm_sort_matmul.cu``, ``csrc/nm_expand_sort.cu``, whose headers say
what bounds them) on CUDA tensors, counting the launch in ``.launches``,
and takes its plain version (``*_ref``) only for tensors on the CPU. The
dense ones take ``kp``, the policy's padded K (default K); the N:M ones
accumulate over the padded G * m_group. The columns past K and the groups
past G are zero products, masked by the card kernels and padded by the
plain versions. The TPU kernels' VMEM budgets (``CUBE_BUDGET``,
``_sort_chunk``) are not carried over: the card kernels choose their own
working sets.
"""

from __future__ import annotations

import torch

from repro_torch.core.overflow import partial_products
from repro_torch.core.sorted_accum import (
    monotone_accumulate,
    pair_permutation,
    paired_order,
    sorted_order,
)
from repro_torch.kernels.nm_spmm import (
    check_nm_sort,
    expanded_operands,
    kept_tiles,
    launch_nm_expand_sort,
    launch_nm_sort_matmul,
    launch_slabs,
    nm_gather_sort_matmul_ref,
    pad_last_pow2,
)
from repro_torch.kernels.sorted_matmul import (
    KERNEL_K_TILES,
    SORT_POLICIES,
    SORT_SMEM_BYTES,
    _check_sort,
    card_operands,
    launch_sort,
    lib_fn,
    next_pow2,
    on_cpu,
    pad_k,
    policy_accumulate_ref,
    row_chunk,
    stream_of,
)


# Pass 1's CUDA bodies. Dense (csrc/sorted_stream.cu): tiles of whole
# slabs of the int8 tensor-core mainloop (csrc/int8_mma.cuh, 64 bytes of
# K a slab) run on it, shorter tiles on a small-tile body. Gather
# (csrc/nm_sort_matmul.cu): up to NM_SUMS_FEW_ROWS rows of x the lanes of
# a warp split a tile's kept slots; above, each lane owns 4 rows of x.
MMA_SLAB = 64
NM_SUMS_FEW_ROWS = 16


def tile_sums_body(k_tile: int, k: int) -> str:
    """The CUDA body ``tile_sums_matmul`` launches for tiles of ``k_tile``
    at K = ``k``: ``"mma"`` (the mainloop with its per-tile epilogue) where
    k_tile is a power-of-two multiple of ``MMA_SLAB`` and K >= 1, else
    ``"small"``."""
    slabs = k_tile // MMA_SLAB
    whole = k_tile % MMA_SLAB == 0 and slabs > 0 and slabs & (slabs - 1) == 0
    return "mma" if whole and k >= 1 else "small"


def nm_tile_sums_body(m: int) -> str:
    """The CUDA body ``nm_gather_tile_sums`` launches for ``m`` rows of x:
    ``"few_rows"`` up to ``NM_SUMS_FEW_ROWS``, else ``"many_rows"``."""
    return "few_rows" if m <= NM_SUMS_FEW_ROWS else "many_rows"


def nm_expand_tile_sums_body(m: int, k_tile: int) -> str:
    """The CUDA body ``nm_tile_sums_matmul`` launches for ``m`` rows of x
    and tiles of ``k_tile``: the gather twin's body (``nm_tile_sums_body``,
    one copy in ``csrc/nm_tile_sums.cuh``, with expand's rule for a slot
    outside its group) where the tile fits its staging, k_tile up to
    ``KERNEL_K_TILES[-1]``; above, ``"warp"``, one warp per (n, tile)."""
    return nm_tile_sums_body(m) if k_tile <= KERNEL_K_TILES[-1] else "warp"


def _empty(x, *shape):
    return torch.empty(shape, dtype=torch.int32, device=x.device)


def tile_sums_matmul_ref(x: torch.Tensor, w: torch.Tensor, *,
                         k_tile: int = 256, kp: int | None = None
                         ) -> torch.Tensor:
    """Plain version of ``tile_sums_matmul`` (any device)."""
    kp = _check_sort(x, w, "sorted_tiled", 16, k_tile, kp)
    x, w = pad_k(x, kp), pad_k(w, kp)
    m, n, t = x.shape[0], w.shape[0], kp // k_tile
    chunk = row_chunk(n, kp)
    outs = [partial_products(w, x[i : i + chunk]).reshape(-1, n, t, k_tile)
            .sum(dim=-1, dtype=torch.int32) for i in range(0, m, chunk)]
    return torch.cat(outs, dim=0) if outs else _empty(x, 0, n, t)


def tile_sums_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     k_tile: int = 256, kp: int | None = None
                     ) -> torch.Tensor:
    """Pass 1: (M, N, kp/k_tile) int32, the exact sum of each output's
    k_tile tiles; kp a multiple of k_tile (a power of two)."""
    kp = _check_sort(x, w, "sorted_tiled", 16, k_tile, kp)
    if on_cpu(x, w):
        return tile_sums_matmul_ref(x, w, k_tile=k_tile, kp=kp)
    x8, w8 = card_operands("tile_sums_matmul", x, w)
    m, k = x8.shape
    n = w8.shape[0]
    out = _empty(x8, m, n, kp // k_tile)
    if out.numel() == 0:
        return out
    err = lib_fn("sorted_stream", "pqs_tile_sums", 3, 5)(
        x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k, kp, k_tile,
        stream_of(x8))
    if err != 0:
        raise RuntimeError(f"tile_sums_matmul launch failed: CUDA error {err}")
    tile_sums_matmul.launches += 1
    return out


tile_sums_matmul.launches = 0


def _check_perm(x, w, perm, kp, k_tile):
    want = (x.shape[0], w.shape[0], kp // k_tile)
    if tuple(perm.shape) != want:
        raise ValueError(f"perm must be (M, N, kp/k_tile) = {want}, got "
                         f"{tuple(perm.shape)}")


def paired_accum_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    perm: torch.Tensor,
    *,
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    kp: int | None = None,
) -> torch.Tensor:
    """Plain version of ``paired_accum_matmul`` (any device): the products
    as (rows, N, T, k_tile) tiles, each sorted, put in perm's paired
    order, then added stepwise with saturation."""
    kp = _check_sort(x, w, "sorted_tiled", acc_bits, k_tile, kp)
    _check_perm(x, w, perm, kp, k_tile)
    x, w = pad_k(x, kp), pad_k(w, kp)
    m, n, t = x.shape[0], w.shape[0], kp // k_tile
    chunk = row_chunk(n, kp)
    outs = []
    for i in range(0, m, chunk):
        tiles = partial_products(w, x[i : i + chunk]).reshape(-1, n, t, k_tile)
        ordered = paired_order(sorted_order(tiles, rounds),
                               perm[i : i + chunk].long())
        outs.append(monotone_accumulate(ordered, acc_bits)[0])
    return torch.cat(outs, dim=0) if outs else _empty(x, 0, n)


def paired_accum_matmul(
    x: torch.Tensor,  # (M, K) int8 (or int32 carrying int8)
    w: torch.Tensor,  # (N, K)
    perm: torch.Tensor,  # (M, N, kp/k_tile) int32 pairing permutation
    *,
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    kp: int | None = None,
) -> torch.Tensor:
    """Pass 2: (M, N) int32, each output's kp in the paired order of its
    row of ``perm`` (a permutation of its tile indices, as
    ``pair_permutation`` gives)."""
    kp = _check_sort(x, w, "sorted_tiled", acc_bits, k_tile, kp)
    _check_perm(x, w, perm, kp, k_tile)
    if on_cpu(x, w, perm):
        return paired_accum_matmul_ref(x, w, perm, acc_bits=acc_bits,
                                       k_tile=k_tile, rounds=rounds, kp=kp)
    if k_tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel sorts tiles of up to {KERNEL_K_TILES[-1]} "
            f"products; k_tile={k_tile}")
    x8, w8 = card_operands("paired_accum_matmul", x, w)
    if perm.device != x8.device or perm.dtype != torch.int32:
        raise ValueError(f"perm must be int32 on {x8.device}, got "
                         f"{perm.dtype} on {perm.device}")
    perm = perm.contiguous()
    m, k = x8.shape
    n = w8.shape[0]
    out = _empty(x8, m, n)
    if out.numel() == 0:
        return out
    err = lib_fn("sorted_stream", "pqs_paired_accum", 4, 7)(
        x8.data_ptr(), w8.data_ptr(), perm.data_ptr(), out.data_ptr(), m, n,
        k, kp, acc_bits, rounds, k_tile, stream_of(x8))
    if err != 0:
        raise RuntimeError(
            f"paired_accum_matmul launch failed: CUDA error {err}")
    paired_accum_matmul.launches += 1
    return out


paired_accum_matmul.launches = 0


def chunked_sort_matmul_ref(x: torch.Tensor, w: torch.Tensor, *,
                            acc_bits: int = 16, rounds: int = 1,
                            kp: int | None = None) -> torch.Tensor:
    """Plain version of ``chunked_sort_matmul`` (any device)."""
    kp = _check_sort(x, w, "sorted", acc_bits, 1, kp)
    return policy_accumulate_ref(pad_k(x, kp), pad_k(w, kp), policy="sorted",
                                 acc_bits=acc_bits, k_tile=kp, rounds=rounds)


def chunked_sort_matmul(x: torch.Tensor, w: torch.Tensor, *,
                        acc_bits: int = 16, rounds: int = 1,
                        kp: int | None = None) -> torch.Tensor:
    """(M, N) int32 under ``sorted`` at long K (kp a power of two, at most
    ``SORTED_MAX_K`` on the card)."""
    kp = _check_sort(x, w, "sorted", acc_bits, 1, kp)
    if on_cpu(x, w):
        return chunked_sort_matmul_ref(x, w, acc_bits=acc_bits, rounds=rounds,
                                       kp=kp)
    out = launch_sort("chunked_sort_matmul", x, w, kp, "sorted", acc_bits, 1,
                      rounds)
    if out.numel():
        chunked_sort_matmul.launches += 1
    return out


chunked_sort_matmul.launches = 0


def stream_sort_matmul(
    x: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (N, K)
    *,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    kp: int | None = None,
) -> torch.Tensor:
    """The streaming entry point for ``sorted`` | ``sorted_tiled``, with
    ``sort_matmul``'s contract (``kp`` the policy's padded K)."""
    if policy not in SORT_POLICIES:
        raise ValueError(f"unknown sort policy {policy!r}; {SORT_POLICIES}")
    if policy == "sorted":
        return chunked_sort_matmul(x, w, acc_bits=acc_bits, rounds=rounds,
                                   kp=kp)
    sums = tile_sums_matmul(x, w, k_tile=k_tile, kp=kp)
    perm = pair_permutation(sums).to(torch.int32)
    return paired_accum_matmul(x, w, perm, acc_bits=acc_bits, k_tile=k_tile,
                               rounds=rounds, kp=kp)


# ---------------------------------------------------------------------------
# the gather twins on N:M compressed slabs
# ---------------------------------------------------------------------------


def nm_gather_tile_sums_ref(x: torch.Tensor, values: torch.Tensor,
                            indices: torch.Tensor, *, m_group: int,
                            k_tile: int = 256) -> torch.Tensor:
    """Plain version of ``nm_gather_tile_sums`` (any device)."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", 16,
                       k_tile)
    n, t = values.shape[0], kp // k_tile
    chunk = row_chunk(n, kp)
    outs = [kept_tiles(x[i : i + chunk], values, indices, m_group, k_tile,
                       kp).sum(dim=-1, dtype=torch.int32)
            for i in range(0, x.shape[0], chunk)]
    return torch.cat(outs, dim=0) if outs else _empty(x, 0, n, t)


def nm_gather_tile_sums(x: torch.Tensor, values: torch.Tensor,
                        indices: torch.Tensor, *, m_group: int,
                        k_tile: int = 256) -> torch.Tensor:
    """Pass 1 on kept products: (M, N, kp/k_tile) int32, equal to
    ``tile_sums_matmul`` on the decompressed weight (pruned positions add
    nothing to a sum)."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", 16,
                       k_tile)
    if on_cpu(x, values, indices):
        return nm_gather_tile_sums_ref(x, values, indices, m_group=m_group,
                                       k_tile=k_tile)
    if k_tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel stages tiles of up to {KERNEL_K_TILES[-1]} "
            f"positions; k_tile={k_tile}")
    out, launched = launch_slabs(
        "nm_sort_matmul", "pqs_nm_gather_tile_sums", x, values, indices,
        m_group=m_group, out_tail=(kp // k_tile,), ints=(kp, k_tile))
    if launched:
        nm_gather_tile_sums.launches += 1
    return out


nm_gather_tile_sums.launches = 0


def nm_gather_paired_accum_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    indices: torch.Tensor,
    perm: torch.Tensor,
    *,
    m_group: int,
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """Plain version of ``nm_gather_paired_accum_matmul`` (any device):
    the kept tiles padded to a power of two, each sorted, put in perm's
    paired order, then added stepwise with saturation."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", acc_bits,
                       k_tile)
    _check_perm(x, values, perm, kp, k_tile)
    n = values.shape[0]
    chunk = row_chunk(n, kp)
    outs = []
    for i in range(0, x.shape[0], chunk):
        tiles = pad_last_pow2(kept_tiles(x[i : i + chunk], values, indices,
                                         m_group, k_tile, kp))
        ordered = paired_order(sorted_order(tiles, rounds),
                               perm[i : i + chunk].long())
        outs.append(monotone_accumulate(ordered, acc_bits)[0])
    return torch.cat(outs, dim=0) if outs else _empty(x, 0, n)


def nm_gather_paired_accum_matmul(
    x: torch.Tensor,  # (M, K) int8 (or int32 carrying int8)
    values: torch.Tensor,  # (N, G, n_keep) int8
    indices: torch.Tensor,  # (N, G, n_keep) int32
    perm: torch.Tensor,  # (M, N, kp/k_tile) int32 pairing permutation
    *,
    m_group: int,
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """Pass 2 on kept products: (M, N) int32, each output's kept tiles in
    the paired order of its row of ``perm``; equal to
    ``paired_accum_matmul`` on the decompressed weight."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", acc_bits,
                       k_tile)
    _check_perm(x, values, perm, kp, k_tile)
    if on_cpu(x, values, indices, perm):
        return nm_gather_paired_accum_matmul_ref(
            x, values, indices, perm, m_group=m_group, acc_bits=acc_bits,
            k_tile=k_tile, rounds=rounds)
    lp = next_pow2((k_tile // m_group) * values.shape[2])
    if lp not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel sorts tiles of up to {KERNEL_K_TILES[-1]} "
            f"kept products; {lp} at k_tile={k_tile}")
    if perm.device != x.device or perm.dtype != torch.int32:
        raise ValueError(f"perm must be int32 on {x.device}, got "
                         f"{perm.dtype} on {perm.device}")
    out, launched = launch_slabs(
        "nm_sort_matmul", "pqs_nm_gather_paired_accum", x, values, indices,
        m_group=m_group, ptrs=(perm.contiguous(),),
        ints=(kp, acc_bits, rounds, k_tile))
    if launched:
        nm_gather_paired_accum_matmul.launches += 1
    return out


nm_gather_paired_accum_matmul.launches = 0


def nm_gather_chunked_sort_matmul_ref(
        x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
        m_group: int, acc_bits: int = 16, rounds: int = 1) -> torch.Tensor:
    """Plain version of ``nm_gather_chunked_sort_matmul`` (any device)."""
    return nm_gather_sort_matmul_ref(x, values, indices, m_group=m_group,
                                     policy="sorted", acc_bits=acc_bits,
                                     rounds=rounds)


def nm_gather_chunked_sort_matmul(
        x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
        m_group: int, acc_bits: int = 16, rounds: int = 1) -> torch.Tensor:
    """(M, N) int32 under ``sorted`` at long K from the kept products
    (next_pow2(G * n_keep) keys an output, at most ``SORTED_MAX_K`` on
    the card); equal to ``chunked_sort_matmul`` on the decompressed
    weight."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted", acc_bits, 1)
    if on_cpu(x, values, indices):
        return nm_gather_chunked_sort_matmul_ref(
            x, values, indices, m_group=m_group, acc_bits=acc_bits,
            rounds=rounds)
    out, launched = launch_nm_sort_matmul(
        x, values, indices, m_group=m_group, policy="sorted",
        acc_bits=acc_bits, k_tile=1, rounds=rounds, kp=kp)
    if launched:
        nm_gather_chunked_sort_matmul.launches += 1
    return out


nm_gather_chunked_sort_matmul.launches = 0


def _nm_stream(chunked, tile_sums, paired, x, values, indices, *, m_group,
               policy, acc_bits, k_tile, rounds):
    """The streaming route on compressed slabs through one family of
    kernels: ``chunked`` for ``sorted``; for ``sorted_tiled`` pass 1
    (``tile_sums``), the pairing in torch, pass 2 (``paired``)."""
    if policy not in SORT_POLICIES:
        raise ValueError(f"unknown sort policy {policy!r}; {SORT_POLICIES}")
    if policy == "sorted":
        return chunked(x, values, indices, m_group=m_group, acc_bits=acc_bits,
                       rounds=rounds)
    sums = tile_sums(x, values, indices, m_group=m_group, k_tile=k_tile)
    perm = pair_permutation(sums).to(torch.int32)
    return paired(x, values, indices, perm, m_group=m_group,
                  acc_bits=acc_bits, k_tile=k_tile, rounds=rounds)


def nm_gather_stream_sort_matmul(
    x: torch.Tensor,  # (M, K) int8
    values: torch.Tensor,  # (N, G, n_keep) int8
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """The streaming entry point for ``sorted`` | ``sorted_tiled`` on
    compressed slabs, with ``nm_gather_sort_matmul``'s contract: the
    chunked kernel for ``sorted``; for ``sorted_tiled`` pass 1, the
    pairing in torch, pass 2."""
    return _nm_stream(nm_gather_chunked_sort_matmul, nm_gather_tile_sums,
                      nm_gather_paired_accum_matmul, x, values, indices,
                      m_group=m_group, policy=policy, acc_bits=acc_bits,
                      k_tile=k_tile, rounds=rounds)


# ---------------------------------------------------------------------------
# the expand twins on N:M compressed slabs
# ---------------------------------------------------------------------------


def nm_tile_sums_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                            indices: torch.Tensor, *, m_group: int,
                            k_tile: int = 256) -> torch.Tensor:
    """Plain version of ``nm_tile_sums_matmul`` (any device): the slabs
    decompressed, then ``tile_sums_matmul_ref`` over kp."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", 16,
                       k_tile)
    return tile_sums_matmul_ref(
        *expanded_operands(x, values, indices, m_group, kp), k_tile=k_tile,
        kp=kp)


def nm_tile_sums_matmul(x: torch.Tensor, values: torch.Tensor,
                        indices: torch.Tensor, *, m_group: int,
                        k_tile: int = 256) -> torch.Tensor:
    """Pass 1 on expanded rows: (M, N, kp/k_tile) int32, equal to
    ``tile_sums_matmul`` on the decompressed weight and, on slabs whose
    indices lie inside their groups, to ``nm_gather_tile_sums``. A slot
    whose index lies outside its group adds nothing, as the expansion
    drops it. Any power-of-two k_tile on the card
    (``nm_expand_tile_sums_body`` names the body)."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", 16,
                       k_tile)
    if on_cpu(x, values, indices):
        return nm_tile_sums_matmul_ref(x, values, indices, m_group=m_group,
                                       k_tile=k_tile)
    out, launched = launch_slabs(
        "nm_expand_sort", "pqs_nm_expand_tile_sums", x, values, indices,
        m_group=m_group, out_tail=(kp // k_tile,), ints=(kp, k_tile))
    if launched:
        nm_tile_sums_matmul.launches += 1
    return out


nm_tile_sums_matmul.launches = 0


def nm_paired_accum_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    indices: torch.Tensor,
    perm: torch.Tensor,
    *,
    m_group: int,
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """Plain version of ``nm_paired_accum_matmul`` (any device): the slabs
    decompressed, then ``paired_accum_matmul_ref`` over kp."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", acc_bits,
                       k_tile)
    _check_perm(x, values, perm, kp, k_tile)
    return paired_accum_matmul_ref(
        *expanded_operands(x, values, indices, m_group, kp), perm,
        acc_bits=acc_bits, k_tile=k_tile, rounds=rounds, kp=kp)


def nm_paired_accum_matmul(
    x: torch.Tensor,  # (M, K) int8 (or int32 carrying int8)
    values: torch.Tensor,  # (N, G, n_keep) int8
    indices: torch.Tensor,  # (N, G, n_keep) int32
    perm: torch.Tensor,  # (M, N, kp/k_tile) int32 pairing permutation
    *,
    m_group: int,
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """Pass 2 on expanded rows: (M, N) int32, each output's dense tiles in
    the paired order of its row of ``perm``; equal to
    ``paired_accum_matmul`` on the decompressed weight and to
    ``nm_gather_paired_accum_matmul``."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted_tiled", acc_bits,
                       k_tile)
    _check_perm(x, values, perm, kp, k_tile)
    if on_cpu(x, values, indices, perm):
        return nm_paired_accum_matmul_ref(
            x, values, indices, perm, m_group=m_group, acc_bits=acc_bits,
            k_tile=k_tile, rounds=rounds)
    if k_tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernel sorts tiles of up to {KERNEL_K_TILES[-1]} "
            f"products; k_tile={k_tile}")
    if 2 * x.shape[1] > SORT_SMEM_BYTES:
        raise NotImplementedError(
            f"the CUDA kernel expands a row of K int16 weights into shared "
            f"memory, at most {SORT_SMEM_BYTES} bytes: K={x.shape[1]}")
    if perm.device != x.device or perm.dtype != torch.int32:
        raise ValueError(f"perm must be int32 on {x.device}, got "
                         f"{perm.dtype} on {perm.device}")
    out, launched = launch_slabs(
        "nm_expand_pass2", "pqs_nm_expand_paired_accum", x, values, indices,
        m_group=m_group, ptrs=(perm.contiguous(),),
        ints=(kp, acc_bits, rounds, k_tile))
    if launched:
        nm_paired_accum_matmul.launches += 1
    return out


nm_paired_accum_matmul.launches = 0


def nm_chunked_sort_matmul_ref(
        x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
        m_group: int, acc_bits: int = 16, rounds: int = 1) -> torch.Tensor:
    """Plain version of ``nm_chunked_sort_matmul`` (any device): the slabs
    decompressed, then ``chunked_sort_matmul_ref`` over kp."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted", acc_bits, 1)
    return chunked_sort_matmul_ref(
        *expanded_operands(x, values, indices, m_group, kp),
        acc_bits=acc_bits, rounds=rounds, kp=kp)


def nm_chunked_sort_matmul(
        x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, *,
        m_group: int, acc_bits: int = 16, rounds: int = 1) -> torch.Tensor:
    """(M, N) int32 under ``sorted`` at long K on expanded rows (kp keys an
    output, at most ``SORTED_MAX_K`` on the card: the `sorted` kernel of
    ``nm_sort_matmul``, counted here); equal to ``chunked_sort_matmul`` on
    the decompressed weight."""
    kp = check_nm_sort(x, values, indices, m_group, "sorted", acc_bits, 1)
    if on_cpu(x, values, indices):
        return nm_chunked_sort_matmul_ref(x, values, indices,
                                          m_group=m_group, acc_bits=acc_bits,
                                          rounds=rounds)
    out, launched = launch_nm_expand_sort(
        x, values, indices, m_group=m_group, policy="sorted",
        acc_bits=acc_bits, k_tile=1, rounds=rounds, kp=kp)
    if launched:
        nm_chunked_sort_matmul.launches += 1
    return out


nm_chunked_sort_matmul.launches = 0


def nm_stream_sort_matmul(
    x: torch.Tensor,  # (M, K) int8
    values: torch.Tensor,  # (N, G, n_keep) int8
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """The streaming entry point for ``sorted`` | ``sorted_tiled`` on
    compressed slabs through the expand twins, with ``nm_sort_matmul``'s
    contract (the JAX package's ``nm_stream_sort_matmul``)."""
    return _nm_stream(nm_chunked_sort_matmul, nm_tile_sums_matmul,
                      nm_paired_accum_matmul, x, values, indices,
                      m_group=m_group, policy=policy, acc_bits=acc_bits,
                      k_tile=k_tile, rounds=rounds)
