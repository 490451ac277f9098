"""PQS accumulation policies on N:M compressed weights for Hopper: the
K-streaming ``nm_gather_seq_policy_matmul`` and ``nm_seq_policy_matmul``,
the one-pass global-sort ``nm_gather_sort_matmul`` and ``nm_sort_matmul``,
and the wide ``nm_spmm``.

Port of ``repro/kernels/nm_spmm.py``. Weights arrive compressed
(``core.pruning``): values (N, G, n_keep) int8 and indices (N, G, n_keep)
int32 in canonical form, against x (M, K) with K <= G * m_group. Each
computes the (M, N) int32 register of the dense kernel on the decompressed
weight, bit for bit:

  gather  forms only the kept products x[m, g*m_group + idx] * value, in
          ascending dense position; for sorted_tiled_seq and sorted_tiled
          each dense k_tile tile is its bg = k_tile / m_group groups' kept
          products, zero-padded to a power of two (``pad_last_pow2``) and
          sorted; ``sorted`` sorts all G * n_keep kept products, padded to a
          power of two. Exact by the zero-product prefix property (the
          headers of ``csrc/nm_seq_policy_matmul.cu`` and
          ``csrc/nm_sort_matmul.cu`` give the argument).
  expand  rebuilds the dense positions from the slabs (``nm_decompress``'s
          scatter-add) and runs the dense kernel's body; the exactness
          oracle of the gather. Its plain versions decompress and run the
          dense plain version.

Each wrapper launches its hand-written CUDA kernel
(``csrc/nm_seq_policy_matmul.cu``, ``csrc/nm_expand_seq.cu``,
``csrc/nm_sort_matmul.cu``,
``csrc/nm_expand_sort.cu``, ``csrc/quant_matmul.cu``) on CUDA tensors,
counting the launch in ``.launches`` (the two K-streaming wrappers also
in ``.policy_launches`` under its policy), and takes its plain version
(``*_ref``) only for tensors on the CPU. The kernels mask ragged M, N, K
and G themselves; the plain versions pad G to whole sort tiles
(``_cover``) or K to kp. The two-pass and chunked kernels of the
global-sort policies are in ``sorted_stream``.
"""

from __future__ import annotations

import torch

from repro_torch.core.overflow import accumulate
from repro_torch.core.pruning import nm_decompress
from repro_torch.core.sorted_accum import (
    monotone_accumulate,
    sorted_order,
    tiled_sorted_order,
)
from repro_torch.kernels.sorted_matmul import (
    KERNEL_K_TILES,
    SEQ_POLICIES,
    SORT_POLICIES,
    _as_int8,
    check_sort_smem,
    lib_fn,
    next_pow2,
    on_cpu,
    pad_k,
    padded_k,
    row_chunk,
    seq_policy_matmul_ref,
    sort_matmul_ref,
    stream_of,
)


def expand_nm_slab(vals: torch.Tensor, idx: torch.Tensor, m_group: int
                   ) -> torch.Tensor:
    """(N, G, n_keep) compressed slab -> dense (N, G*m_group) int32, the
    int32 scatter-add of the slots, as the JAX package's one-hot expansion
    (``nm_onehot_expand``): a slot whose index lies outside [0, m_group)
    adds nothing, and slots at one position add in int32."""
    inside = (idx >= 0) & (idx < m_group)
    return nm_decompress(torch.where(inside, vals.to(torch.int32), 0),
                         torch.where(inside, idx, 0), m_group)


def pad_last_pow2(a: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis up to a power of two (bitonic-sortable);
    zero products are inert through sort, saturation and wraparound."""
    n = a.shape[-1]
    p = 1 if n <= 1 else 1 << (n - 1).bit_length()
    return a if p == n else torch.nn.functional.pad(a, (0, p - n))


def gather_nm_products(xb: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor, m_group: int,
                       width: int | None = None) -> torch.Tensor:
    """Kept-only partial products: xb (M, K), vals/idx (N, G, n_keep) ->
    (M, N, G*n_keep) int32, slot j of group g being x[m, p] * value at
    p = g*m_group + idx, with x zero-extended to ``width`` columns (default
    G*m_group; K <= width). The port's rule for a position outside the
    row: one in [-width, 0) wraps from the row's end, as the JAX gather
    kernels' ``take_along_axis`` does where their x block is the whole row
    (``overflow.nm_partial_products`` on canonical slabs); one below
    -width, or at or past width, is a zero product, where the JAX kernels
    read a fill value. Every gather kernel of the port follows it, with
    width the padded K (``kp``) of the global-sort kernels and G*m_group
    for the K-streaming one."""
    n, g, n_keep = vals.shape
    width = g * m_group if width is None else width
    x = xb.to(torch.int32)
    if x.shape[-1] < width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    base = torch.arange(g, device=idx.device, dtype=torch.int64) * m_group
    pos = (idx.to(torch.int64) + base[:, None]).reshape(n, g * n_keep)
    pos = torch.where(pos < 0, pos + width, pos)
    inside = (pos >= 0) & (pos < width)
    v = torch.where(inside, vals.reshape(n, g * n_keep).to(torch.int32), 0)
    return x[:, torch.where(inside, pos, 0)] * v


def _check(x, values, indices, m_group, policy, acc_bits, k_tile) -> None:
    if policy not in SEQ_POLICIES:
        raise ValueError(f"unknown seq policy {policy!r}; {SEQ_POLICIES}")
    if x.ndim != 2 or values.ndim != 3 or values.shape != indices.shape:
        raise ValueError(f"expected x (M, K) and matching (N, G, n_keep) "
                         f"slabs, got {tuple(x.shape)}, "
                         f"{tuple(values.shape)} and {tuple(indices.shape)}")
    n_keep, g = values.shape[2], values.shape[1]
    if m_group < 1 or not 1 <= n_keep <= m_group:
        raise ValueError(f"n_keep={n_keep} out of range [1, m_group] for "
                         f"m_group={m_group}")
    if x.shape[1] > g * m_group:
        raise ValueError(f"contraction mismatch: x has K={x.shape[1]} but "
                         f"the slabs cover G*m = {g}*{m_group}")
    if not 2 <= acc_bits <= 30:
        raise ValueError(f"acc_bits={acc_bits} outside [2, 30]")
    if policy == "sorted_tiled_seq" and (
            k_tile <= 0 or k_tile & (k_tile - 1) or k_tile % m_group):
        raise ValueError(f"k_tile must be a power of 2 and a multiple of "
                         f"m_group={m_group}, got {k_tile}")


def _cover(x, values, indices, m_group, groups):
    """The slabs padded with zero groups up to ``groups`` (none below G),
    and x zero-extended to cover their columns: zero products, inert
    under every policy (plain versions)."""
    g = values.shape[1]
    if groups > g:
        values = torch.nn.functional.pad(values, (0, 0, 0, groups - g))
        indices = torch.nn.functional.pad(indices, (0, 0, 0, groups - g))
    width = max(groups, g) * m_group
    if x.shape[1] < width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[1]))
    return x, values, indices


def nm_seq_policy_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    indices: torch.Tensor,
    *,
    m_group: int,
    policy: str = "clip",
    acc_bits: int = 16,
    rounds: int = 1,
    k_tile: int = 256,
) -> torch.Tensor:
    """Plain version of the expand kernel: decompress, then the dense
    plain version."""
    _check(x, values, indices, m_group, policy, acc_bits, k_tile)
    w = expand_nm_slab(values, indices, m_group)
    x = torch.nn.functional.pad(x, (0, w.shape[1] - x.shape[1]))
    return seq_policy_matmul_ref(x, w, policy=policy, acc_bits=acc_bits,
                                 rounds=rounds, k_tile=k_tile)


def nm_gather_seq_policy_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    indices: torch.Tensor,
    *,
    m_group: int,
    policy: str = "clip",
    acc_bits: int = 16,
    rounds: int = 1,
    k_tile: int = 256,
) -> torch.Tensor:
    """Plain version of the gather kernel: the kept products formed
    explicitly (``gather_nm_products``); for sorted_tiled_seq each tile of
    bg = k_tile / m_group groups is padded to a power of two and sorted on
    its own (``overflow.accumulate`` with that tile), then the register
    steps through the stream."""
    _check(x, values, indices, m_group, policy, acc_bits, k_tile)
    bg = k_tile // m_group if policy == "sorted_tiled_seq" else 1
    g = values.shape[1]
    width = g * m_group  # a position wraps within the slabs' dense row
    x, values, indices = _cover(x, values, indices, m_group, g + (-g) % bg)
    n, g, n_keep = values.shape
    tile = bg * n_keep
    chunk = row_chunk(n, g * n_keep)
    outs = []
    for i in range(0, x.shape[0], chunk):
        prods = gather_nm_products(x[i : i + chunk, :width], values, indices,
                                   m_group, width)
        seg = k_tile
        if policy == "sorted_tiled_seq":
            tiles = pad_last_pow2(prods.reshape(*prods.shape[:2], -1, tile))
            seg = tiles.shape[-1]
            prods = tiles.reshape(*prods.shape[:2], -1)
        outs.append(accumulate(prods, acc_bits, policy, seg, rounds))
    if not outs:
        return torch.zeros((0, n), dtype=torch.int32, device=x.device)
    return torch.cat(outs, dim=0)


def card_slabs(name, x, values, indices):
    """x, values and indices as contiguous int8, int8 and int32 on one CUDA
    device; raises on anything else (an int32 carrier of int8 values is
    narrowed, as for the dense kernels)."""
    devices = {x.device, values.device, indices.device}
    if len(devices) != 1 or not x.is_cuda:
        raise ValueError(f"x, values and indices must share one CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {indices.dtype}")
    x8, v8 = _as_int8(x, "x"), _as_int8(values, "values")
    if not (x8.is_contiguous() and v8.is_contiguous()
            and indices.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    return x8, v8, indices


def launch_slabs(source, name, x, values, indices, *, m_group, out_tail=(),
                 ptrs=(), ints=()):
    """Launch the C function ``name`` of csrc/<source>.cu on CUDA tensors:
    x, the slabs, ``ptrs`` (tensors), the (M, N, *out_tail) int32 out, M,
    N, K, G, n_keep, m_group, then ``ints``. Returns (out, whether a kernel
    was launched)."""
    x8, v8, indices = card_slabs(name, x, values, indices)
    m, k = x8.shape
    n, g, n_keep = v8.shape
    out = torch.empty((m, n, *out_tail), dtype=torch.int32, device=x8.device)
    if out.numel() == 0:
        return out, False
    if k == 0 or g == 0:
        return out.zero_(), False
    fn = lib_fn(source, name, 4 + len(ptrs), 6 + len(ints))
    err = fn(x8.data_ptr(), v8.data_ptr(), indices.data_ptr(),
             *(t.data_ptr() for t in ptrs), out.data_ptr(), m, n, k, g,
             n_keep, m_group, *ints, stream_of(x8))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out, True


def _launch(source, name, x, values, indices, *, m_group, policy, acc_bits,
            rounds, k_tile):
    """Launch ``name`` of csrc/<source>.cu on CUDA tensors. Returns (out,
    whether a kernel was launched)."""
    if policy == "sorted_tiled_seq" and k_tile not in KERNEL_K_TILES:
        raise NotImplementedError(
            f"the CUDA kernels sort tiles of up to {KERNEL_K_TILES[-1]} "
            f"dense positions; k_tile={k_tile}")
    return launch_slabs(source, name, x, values, indices,
                        m_group=m_group, ints=(SEQ_POLICIES.index(policy),
                                               acc_bits, rounds, k_tile))


def nm_gather_seq_policy_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    values: torch.Tensor,  # (N, G, n_keep) int8, K <= G * m_group
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int,
    policy: str = "clip",
    acc_bits: int = 16,
    rounds: int = 1,
    k_tile: int = 256,
) -> torch.Tensor:
    """(M, N) int32 from the kept products only: the CUDA gather kernel
    on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
              rounds=rounds, k_tile=k_tile)
    if x.device.type == values.device.type == indices.device.type == "cpu":
        return nm_gather_seq_policy_matmul_ref(x, values, indices, **kw)
    _check(x, values, indices, m_group, policy, acc_bits, k_tile)
    out, launched = _launch("nm_seq_policy_matmul",
                            "pqs_nm_gather_seq_policy_matmul", x, values,
                            indices, **kw)
    if launched:
        nm_gather_seq_policy_matmul.launches += 1
        nm_gather_seq_policy_matmul.policy_launches[policy] += 1
    return out


def nm_seq_policy_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    values: torch.Tensor,  # (N, G, n_keep) int8, K <= G * m_group
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int,
    policy: str = "clip",
    acc_bits: int = 16,
    rounds: int = 1,
    k_tile: int = 256,
) -> torch.Tensor:
    """(M, N) int32 with the compressed rows expanded to their dense
    positions (the int32 sums of their slots): on CUDA tensors the CUDA
    expand kernel (clip and sorted_tiled_seq: each row expanded once a
    window for up to 4 rows of x, rows packed in pairs, an output's tiles
    split over warps; wide and wrap: ``nm_spmm``'s tensor-core kernel, wrap
    with its floor mod as the epilogue), on CPU tensors the plain version.
    Slabs whose slots name one position twice take the kernels' int32
    routes, so every slab gives the plain version's result. ``launches``
    counts one a call; under wrap where K is split over blocks (every
    qwen2-1.5b site at decode) that call is two kernels on the card, the
    mainloop and then ``wrap_kernel`` on the summed output."""
    kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
              rounds=rounds, k_tile=k_tile)
    if x.device.type == values.device.type == indices.device.type == "cpu":
        return nm_seq_policy_matmul_ref(x, values, indices, **kw)
    _check(x, values, indices, m_group, policy, acc_bits, k_tile)
    out, launched = _launch("nm_expand_seq", "pqs_nm_seq_policy_matmul", x,
                            values, indices, **kw)
    if launched:
        nm_seq_policy_matmul.launches += 1
        nm_seq_policy_matmul.policy_launches[policy] += 1
    return out


nm_gather_seq_policy_matmul.launches = 0
nm_seq_policy_matmul.launches = 0
nm_gather_seq_policy_matmul.policy_launches = dict.fromkeys(SEQ_POLICIES, 0)
nm_seq_policy_matmul.policy_launches = dict.fromkeys(SEQ_POLICIES, 0)


# ---------------------------------------------------------------------------
# the wide matmul on compressed slabs
# ---------------------------------------------------------------------------


def nm_spmm_ref(x: torch.Tensor, values: torch.Tensor,
                indices: torch.Tensor, *, m_group: int = 16) -> torch.Tensor:
    """Plain version of ``nm_spmm`` (any device): the expand kernel's plain
    version under ``wide`` (decompress by scatter-add, then the row-chunked
    int32 sum of ``quant_matmul_ref``)."""
    return nm_seq_policy_matmul_ref(x, values, indices, m_group=m_group,
                                    policy="wide")


def nm_spmm(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    values: torch.Tensor,  # (N, G, n_keep) int8, K <= G * m_group
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int = 16,
) -> torch.Tensor:
    """(M, N) int32 exact sums on compressed slabs, equal to
    ``quant_matmul`` on the decompressed weight: the CUDA kernel of
    ``csrc/quant_matmul.cu`` (each slab's bytes built in shared memory from
    its values and indices, then the tensor-core mainloop of
    ``csrc/int8_mma.cuh``) on CUDA tensors, the plain version on CPU
    tensors. The kernel masks ragged M, N, K and G.

    On any slabs it equals the plain version and the JAX kernel: a slot
    whose index leaves its group adds nothing, as the JAX kernel's one-hot
    drops it, and slots that name one position add in int32 (a block whose
    slabs do that takes the kernel's exact int32 route; canonical slabs,
    ``pruning.nm_compress``'s, never do)."""
    _check(x, values, indices, m_group, "wide", 16, 256)
    if on_cpu(x, values, indices):
        return nm_spmm_ref(x, values, indices, m_group=m_group)
    out, launched = launch_slabs("quant_matmul", "pqs_nm_spmm", x, values,
                                 indices, m_group=m_group)
    if launched:
        nm_spmm.launches += 1
    return out


nm_spmm.launches = 0


# ---------------------------------------------------------------------------
# the global-sort policies on kept products
# ---------------------------------------------------------------------------


def check_nm_sort(x, values, indices, m_group, policy, acc_bits, k_tile
                  ) -> int:
    """The N:M global-sort kernels' contract (the JAX kernels'
    asserts). Returns kp = ``padded_k(G * m_group)``, the dense path's
    padded K: a power of two for ``sorted``, whole k_tile tiles for
    ``sorted_tiled``. x may be up to kp wide; groups past G up to
    kp/m_group are zero products (the JAX caller pads them; the kernels
    mask them)."""
    if policy not in SORT_POLICIES:
        raise ValueError(f"unknown sort policy {policy!r}; {SORT_POLICIES}")
    if x.ndim != 2 or values.ndim != 3 or values.shape != indices.shape:
        raise ValueError(f"expected x (M, K) and matching (N, G, n_keep) "
                         f"slabs, got {tuple(x.shape)}, "
                         f"{tuple(values.shape)} and {tuple(indices.shape)}")
    g, n_keep = values.shape[1], values.shape[2]
    if m_group < 1 or not 1 <= n_keep <= m_group:
        raise ValueError(f"n_keep={n_keep} out of range [1, m_group] for "
                         f"m_group={m_group}")
    if not 2 <= acc_bits <= 30:
        raise ValueError(f"acc_bits={acc_bits} outside [2, 30]")
    if policy == "sorted_tiled" and (
            k_tile <= 0 or k_tile & (k_tile - 1) or k_tile % m_group):
        raise ValueError(f"k_tile must be a power of 2 and a multiple of "
                         f"m_group={m_group}, got {k_tile}")
    kp = padded_k(g * m_group, policy, k_tile)
    if x.shape[1] > kp:
        raise ValueError(f"contraction mismatch: x has K={x.shape[1]}, "
                         f"above the slabs' padded K {kp} (G*m = "
                         f"{g}*{m_group})")
    return kp


def kept_tiles(x, values, indices, m_group, k_tile, kp):
    """(M, N, kp/k_tile, lc) int32: each k_tile tile of the dense axis as
    its lc = (k_tile/m_group) * n_keep kept products (groups past G are
    zero products)."""
    x, values, indices = _cover(x, values, indices, m_group, kp // m_group)
    prods = gather_nm_products(x, values, indices, m_group, kp)
    return prods.reshape(*prods.shape[:2], kp // k_tile, -1)


def _row_chunks(x, n, length, fn):
    """The (M, N) registers of fn over row chunks of x (the plain versions
    hold (rows, N, length) products at a time)."""
    chunk = row_chunk(n, length)
    outs = [fn(x[i : i + chunk]) for i in range(0, x.shape[0], chunk)]
    if not outs:
        return torch.zeros((0, n), dtype=torch.int32, device=x.device)
    return torch.cat(outs, dim=0)


def nm_gather_sort_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    indices: torch.Tensor,
    *,
    m_group: int,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """Plain version of ``nm_gather_sort_matmul`` (any device), from the
    kept products (``gather_nm_products``): ``sorted`` orders all of them
    padded to a power of two; ``sorted_tiled`` regroups them into the
    kp/k_tile tiles of lc kept products, each padded to lp =
    next_pow2(lc), and runs ``tiled_sorted_order`` over tiles of lp; then
    the register steps through the stream."""
    kp = check_nm_sort(x, values, indices, m_group, policy, acc_bits, k_tile)
    n, g, n_keep = values.shape
    if policy == "sorted":
        def run(xc):
            prods = pad_last_pow2(gather_nm_products(xc, values, indices,
                                                     m_group, kp))
            return monotone_accumulate(sorted_order(prods, rounds),
                                       acc_bits)[0]

        return _row_chunks(x, n, next_pow2(g * n_keep), run)
    lp = next_pow2((k_tile // m_group) * n_keep)

    def run(xc):
        tiles = pad_last_pow2(kept_tiles(xc, values, indices, m_group, k_tile,
                                         kp))
        ordered = tiled_sorted_order(tiles.reshape(*tiles.shape[:2], -1), lp,
                                     rounds)
        return monotone_accumulate(ordered, acc_bits)[0]

    return _row_chunks(x, n, (kp // k_tile) * lp, run)


def launch_nm_sort_matmul(x, values, indices, *, m_group, policy, acc_bits,
                          k_tile, rounds, kp):
    """``pqs_nm_gather_sort_matmul`` of csrc/nm_sort_matmul.cu (a block
    per compressed row and up to 4 rows of x, every product formed once in
    shared memory; ``sorted`` past 2048 kept keys a block per output)
    under ``policy``, with the shared-memory guard of the dense one-pass
    kernel and a row's products; the caller counts the launch."""
    n_keep = values.shape[2]
    if policy == "sorted":
        check_sort_smem(policy, kp, 1, keys=next_pow2(values.shape[1] *
                                                     n_keep))
    else:
        # a block keeps a row's T * lc products (int16, 4 at a time)
        lc = (k_tile // m_group) * n_keep
        stride = -(-(kp // k_tile) * lc // 4) * 4
        check_sort_smem(policy, kp, k_tile, tile=next_pow2(lc),
                        row=-(-2 * stride // 16) * 16)
    return launch_slabs("nm_sort_matmul", "pqs_nm_gather_sort_matmul", x,
                        values, indices, m_group=m_group, ints=(
                            kp, SORT_POLICIES.index(policy), acc_bits,
                            rounds, k_tile))


def nm_gather_sort_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    values: torch.Tensor,  # (N, G, n_keep) int8
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """(M, N) int32 under ``sorted`` or ``sorted_tiled`` from the kept
    products, each output's whole stream at once: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. Equal to ``sort_matmul`` on
    the decompressed weight over kp, the policy's padded G * m_group."""
    kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
              k_tile=k_tile, rounds=rounds)
    kp = check_nm_sort(x, values, indices, m_group, policy, acc_bits, k_tile)
    if on_cpu(x, values, indices):
        return nm_gather_sort_matmul_ref(x, values, indices, **kw)
    out, launched = launch_nm_sort_matmul(x, values, indices, kp=kp, **kw)
    if launched:
        nm_gather_sort_matmul.launches += 1
    return out


nm_gather_sort_matmul.launches = 0


# ---------------------------------------------------------------------------
# the global-sort policies on expanded rows
# ---------------------------------------------------------------------------


def expanded_operands(x, values, indices, m_group, kp):
    """x and the decompressed weight (``expand_nm_slab``: a scatter-add),
    both zero-extended to kp columns: the dense operands the expand plain
    versions run the dense plain versions on."""
    return pad_k(x, kp), pad_k(expand_nm_slab(values, indices, m_group), kp)


def nm_sort_matmul_ref(
    x: torch.Tensor,
    values: torch.Tensor,
    indices: torch.Tensor,
    *,
    m_group: int,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """Plain version of ``nm_sort_matmul`` (any device): the slabs
    decompressed, then ``sort_matmul_ref`` over kp."""
    kp = check_nm_sort(x, values, indices, m_group, policy, acc_bits, k_tile)
    return sort_matmul_ref(*expanded_operands(x, values, indices, m_group, kp),
                           policy=policy, acc_bits=acc_bits, k_tile=k_tile,
                           rounds=rounds)


# device -> the int32 route's slot flags (zero between launches; every
# block that takes a slot gives it back)
_EXPAND_BUSY: dict[torch.device, torch.Tensor] = {}
# (device, stream) -> the int32 route's pool, grown to the largest K yet:
# launches on one stream run in order, so they can share it
_EXPAND_POOL: dict[tuple[torch.device, int], torch.Tensor] = {}
# ints of a pool slot's radix control block (csrc/nm_expand_sort.cu
# kPoolCtlInts: pqs_accum.cuh radix_ctl_ints(16))
_POOL_CTL_INTS = 256 * 16 + 32


def expand_scratch(x, policy):
    """The pool and slot flags of the expand `sorted` kernel's int32 route
    (a row whose expanded weights leave int8 sorts int32 keys in device
    memory): one slot a streaming multiprocessor, each a radix control
    block and two buffers of K int32 (csrc/nm_expand_sort.cu
    ``pool_slot_ints``), taken by a block only on that route; none is
    needed under ``sorted_tiled``. The pool is kept for the device and
    the current stream and grown when a longer K arrives. Returns (pool,
    busy, slots)."""
    busy = _EXPAND_BUSY.get(x.device)
    if busy is None:
        slots = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        busy = torch.zeros(slots, dtype=torch.int32, device=x.device)
        _EXPAND_BUSY[x.device] = busy
    slots = busy.numel()
    slot = _POOL_CTL_INTS + (2 * x.shape[1] + 3) // 4 * 4
    size = slots * slot if policy == "sorted" else 0
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    pool = _EXPAND_POOL.get(key)
    if pool is None or pool.numel() < size:
        pool = torch.empty(size, dtype=torch.int32, device=x.device)
        _EXPAND_POOL[key] = pool
    return pool, busy, slots


def launch_nm_expand_sort(x, values, indices, *, m_group, policy, acc_bits,
                          k_tile, rounds, kp):
    """``pqs_nm_expand_sort_matmul`` of csrc/nm_expand_sort.cu (one block
    per output, the row expanded in shared memory: an int16 row of K
    weights, beside the tile sums under ``sorted_tiled``; under ``sorted``
    the keys in registers or the radix buffers, and a row whose weights
    leave int8 in ``expand_scratch``) under ``policy``; the caller counts
    the launch."""
    check_sort_smem(policy, kp, k_tile,
                    row=0 if policy == "sorted" else 2 * x.shape[1])
    pool, busy, slots = expand_scratch(x, policy)
    return launch_slabs("nm_expand_sort", "pqs_nm_expand_sort_matmul", x,
                        values, indices, m_group=m_group, ptrs=(pool, busy),
                        ints=(kp, SORT_POLICIES.index(policy), acc_bits,
                              rounds, k_tile, slots))


def nm_sort_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    values: torch.Tensor,  # (N, G, n_keep) int8
    indices: torch.Tensor,  # (N, G, n_keep) int32
    *,
    m_group: int,
    policy: str = "sorted",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
) -> torch.Tensor:
    """(M, N) int32 under ``sorted`` or ``sorted_tiled`` with each
    compressed row expanded to its dense positions, each output's whole
    stream at once: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Equal to ``sort_matmul`` on the decompressed weight over
    kp, the policy's padded G * m_group, and to ``nm_gather_sort_matmul``."""
    kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
              k_tile=k_tile, rounds=rounds)
    kp = check_nm_sort(x, values, indices, m_group, policy, acc_bits, k_tile)
    if on_cpu(x, values, indices):
        return nm_sort_matmul_ref(x, values, indices, **kw)
    out, launched = launch_nm_expand_sort(x, values, indices, kp=kp, **kw)
    if launched:
        nm_sort_matmul.launches += 1
    return out


nm_sort_matmul.launches = 0
