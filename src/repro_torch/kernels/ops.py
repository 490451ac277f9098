"""Padding and routing around the port's kernels, torch port of
``repro.kernels.ops``.

``policy_matmul`` pads K by the policy's rule (``padded_k``) and routes
the K-streaming policies to ``sorted_matmul.seq_policy_matmul`` and the
global-sort policies (``sorted``, ``sorted_tiled``) to the one-pass
``sorted_matmul.sort_matmul`` or the two-pass
``sorted_stream.stream_sort_matmul`` (``resolve_sort_impl``); these take
the padded K as ``kp`` and extend the rows with zero products themselves
(the card kernels mask them), so no padded copy of the weight is made.
``nm_policy_matmul`` routes every policy on N:M compressed slabs to the
gather or the expand kernels (``resolve_nm_impl``): the K-streaming
policies to those of ``nm_spmm``, the global-sort policies one-pass to
``nm_spmm.nm_gather_sort_matmul`` / ``nm_sort_matmul`` and two-pass to
``sorted_stream.nm_gather_stream_sort_matmul`` / ``nm_stream_sort_matmul``
(``resolve_sort_impl`` on the dense path's padded K). The quickstart's
entry points sit beside them: the wide ``quant_matmul`` and ``nm_spmm``
(the kernels' own wrappers: they mask every edge, so nothing is padded),
``sorted_matmul`` and ``clip_matmul`` (``policy_matmul`` under
``sorted_tiled_seq`` and ``clip``) and the host packer
``compress_nm_weights``. The TPU block table and block keywords (``bm``,
``bn``, ``bg``, ``quant_matmul``'s ``bk``), its environment overrides and
the autotuner are not carried over — their numbers were VMEM budgets of
the TPU — and neither is ``interpret``: the tensors' device decides.
"""

from __future__ import annotations

import torch

from repro_torch.core.pruning import nm_compress
from repro_torch.kernels.nm_spmm import (  # noqa: F401 (nm_spmm: entry point)
    nm_gather_seq_policy_matmul,
    nm_gather_sort_matmul,
    nm_seq_policy_matmul,
    nm_sort_matmul,
    nm_spmm,
)
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: F401
from repro_torch.kernels.sorted_matmul import (
    SEQ_POLICIES,
    SORT_POLICIES,
    _as_int8,
    next_pow2,
    on_cpu,
    padded_k,
    seq_policy_matmul,
    sort_matmul,
)
from repro_torch.kernels.sorted_stream import (
    nm_gather_stream_sort_matmul,
    nm_stream_sort_matmul,
    stream_sort_matmul,
)

POLICIES = SEQ_POLICIES + SORT_POLICIES
NM_IMPLS = ("auto", "expand", "gather")
# Below this many groups ``auto`` takes expand. The value is the JAX
# package's, set on the TPU; the port keeps the JAX rule so that ``auto``
# picks the kernels the JAX package picks (chip_smoke.py phase 5 times
# both families at a few groups on the card).
GATHER_MIN_G = 8
# ``auto`` takes the one-pass global-sort kernel up to MAX_RESIDENT_K
# (padded) and the two-pass pipeline above it, which is refused past
# MAX_STREAM_K. Both values are the JAX package's, sized for TPU VMEM; the
# port keeps them for the cut until the card's own one-pass and two-pass
# times re-derive it. The card kernels themselves reach further
# (sorted_matmul.SORT_SMEM_BYTES, SORTED_MAX_K).
MAX_RESIDENT_K = 4096
MAX_STREAM_K = 65536
SORT_IMPLS = ("auto", "onepass", "twopass")


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]  # last axis first
    return torch.nn.functional.pad(x, widths)


def resolve_sort_impl(kp: int, interpret: bool,
                      sort_impl: str = "auto") -> str:
    """Which global-sort kernel serves a (padded-)K request: ``auto``
    takes the one-pass kernel up to ``MAX_RESIDENT_K`` and the two-pass
    pipeline above it. On the card (``interpret`` False) an explicit
    ``onepass`` above ``MAX_RESIDENT_K`` and ``twopass`` above
    ``MAX_STREAM_K`` raise; the plain versions on the CPU (``interpret``
    True, as the JAX package's interpret mode) take any K."""
    if sort_impl not in SORT_IMPLS:
        raise ValueError(
            f"sort_impl must be one of {SORT_IMPLS}, got {sort_impl!r}")
    if sort_impl == "auto":
        sort_impl = "onepass" if kp <= MAX_RESIDENT_K else "twopass"
    if interpret:
        return sort_impl
    if sort_impl == "onepass" and kp > MAX_RESIDENT_K:
        raise ValueError(
            f"one-pass sort kernel needs K={kp} resident, above the "
            f"bound {MAX_RESIDENT_K}; use sort_impl='twopass' (default "
            "above the bound)")
    if sort_impl == "twopass" and kp > MAX_STREAM_K:
        raise ValueError(
            f"two-pass sort pipeline takes K up to MAX_STREAM_K="
            f"{MAX_STREAM_K}, got K={kp}; use policy='sorted_tiled_seq' "
            "(fully K-streaming) or backend='torch'")
    return sort_impl


def policy_matmul(
    x: torch.Tensor,  # (M, K) integer carrier
    w: torch.Tensor,  # (N, K) integer carrier
    *,
    policy: str = "wide",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    sort_impl: str = "auto",
    census: bool = True,
) -> torch.Tensor:
    """(M, N) int32 under any accumulation policy, any shape.

    The global-sort policies go to the one-pass ``sort_matmul`` or the
    two-pass ``stream_sort_matmul`` as ``resolve_sort_impl`` picks (the
    two-pass slabs are narrowed to int8). ``census=False`` is the
    certified route: a proof says no partial sum reaches the acc_bits
    caps, so the request is served by the exact ``wide`` body.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
    if not census:
        policy = "wide"  # provably saturate-free -> exact wide body
    kp = padded_k(x.shape[1], policy, k_tile)
    if policy in SORT_POLICIES:
        if resolve_sort_impl(kp, on_cpu(x, w), sort_impl) == "onepass":
            return sort_matmul(x, w, policy=policy, acc_bits=acc_bits,
                               k_tile=k_tile, rounds=rounds, kp=kp)
        return stream_sort_matmul(_as_int8(x, "x"), _as_int8(w, "w"),
                                  policy=policy, acc_bits=acc_bits,
                                  k_tile=k_tile, rounds=rounds, kp=kp)
    xp = _pad_to(x, kp, 1)
    wp = _pad_to(w, kp, 1)
    return seq_policy_matmul(xp, wp, policy=policy, acc_bits=acc_bits,
                             rounds=rounds, k_tile=k_tile)


def resolve_nm_impl(policy: str, g: int, n_keep: int, m_group: int,
                    nm_impl: str | None = None) -> str:
    """Which N:M kernel serves a compressed matmul: an explicit
    ``expand``/``gather`` wins; ``auto`` (or None) takes gather unless
    the storage is dense-as-sparse (n_keep >= m_group), the policy is
    ``wide``, or there are fewer than ``GATHER_MIN_G`` groups. The JAX
    package's ``REPRO_PQS_NM_IMPL`` environment override is not carried
    over."""
    impl = "auto" if nm_impl is None else nm_impl
    if impl not in NM_IMPLS:
        raise ValueError(f"nm_impl must be one of {NM_IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    if n_keep >= m_group or policy == "wide" or g < GATHER_MIN_G:
        return "expand"
    return "gather"


def nm_policy_matmul(
    x: torch.Tensor,  # (M, K) integer carrier, K <= G * m_group
    values: torch.Tensor,  # (N, G, n_keep) int8 compressed weights
    indices: torch.Tensor,  # (N, G, n_keep) int32 in-group positions
    *,
    m_group: int,
    policy: str = "wide",
    acc_bits: int = 16,
    k_tile: int = 256,
    rounds: int = 1,
    sort_impl: str = "auto",
    nm_impl: str | None = None,
    census: bool = True,
) -> torch.Tensor:
    """(M, N) int32 under any policy, directly on N:M compressed slabs;
    bit-identical to ``policy_matmul`` on the decompressed weight.

    The K-streaming policies go to the kernel ``resolve_nm_impl`` picks.
    Their sort tile is the dense one: for sorted_tiled_seq, bg = k_tile /
    m_group groups, so k_tile must be a multiple of m_group. The kernels
    mask a ragged last tile (groups past G, positions past K) themselves
    and the plain versions pad G to whole tiles.

    The global-sort policies take the dense path's padded K, kp =
    ``padded_k(G * m_group)``, and ``resolve_sort_impl``'s route: the
    one-pass kernel (``nm_spmm.nm_gather_sort_matmul`` or, for expand,
    ``nm_sort_matmul``) or the two-pass pipeline
    (``sorted_stream.nm_gather_stream_sort_matmul`` or
    ``nm_stream_sort_matmul``, its x narrowed to int8); groups past G up
    to kp are masked in the kernels, so nothing is padded.
    ``census=False`` is the certified route, as on ``policy_matmul``.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
    if not census:
        policy = "wide"  # provably saturate-free -> exact wide body
    if values.shape != indices.shape or values.ndim != 3:
        raise ValueError(f"expected matching (N, G, n_keep) slabs, got "
                         f"{tuple(values.shape)} / {tuple(indices.shape)}")
    _, g, n_keep = values.shape
    k_dense = g * m_group
    if x.shape[1] > k_dense:
        raise ValueError(
            f"contraction mismatch: x has K={x.shape[1]} but the "
            f"compressed weights cover G*m = {g}*{m_group} = {k_dense}")
    if policy in ("sorted_tiled", "sorted_tiled_seq") and k_tile % m_group:
        raise ValueError(
            f"tiled policies need k_tile % m_group == 0 so tile "
            f"boundaries align with the compressed groups; got "
            f"k_tile={k_tile}, m_group={m_group}")
    impl = resolve_nm_impl(policy, g, n_keep, m_group, nm_impl)
    if policy in SORT_POLICIES:
        kp = padded_k(k_dense, policy, k_tile)
        route = resolve_sort_impl(kp, on_cpu(x, values, indices), sort_impl)
        kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
                  k_tile=k_tile, rounds=rounds)
        gather = impl == "gather"
        if route == "onepass":
            fn = nm_gather_sort_matmul if gather else nm_sort_matmul
            return fn(x, values, indices, **kw)
        fn = nm_gather_stream_sort_matmul if gather else nm_stream_sort_matmul
        return fn(_as_int8(x, "x"), values, indices, **kw)
    fn = nm_gather_seq_policy_matmul if impl == "gather" \
        else nm_seq_policy_matmul
    return fn(x, values, indices, m_group=m_group, policy=policy,
              acc_bits=acc_bits, rounds=rounds, k_tile=k_tile)


def sorted_matmul(x: torch.Tensor, w: torch.Tensor, *, acc_bits: int = 16,
                  rounds: int = 1, bk: int = 256) -> torch.Tensor:
    """PQS tiled-sort matmul: (M, K) x (N, K) -> (M, N) int32 at
    acc_bits, ``bk`` the sort tile (``sorted_tiled_seq``)."""
    return policy_matmul(x, w, policy="sorted_tiled_seq", acc_bits=acc_bits,
                         k_tile=bk, rounds=rounds)


def clip_matmul(x: torch.Tensor, w: torch.Tensor, *, acc_bits: int = 16,
                bk: int = 256) -> torch.Tensor:
    """Natural-order saturating matmul: (M, K) x (N, K) -> (M, N) int32."""
    return policy_matmul(x, w, policy="clip", acc_bits=acc_bits, k_tile=bk)


def compress_nm_weights(w, n_keep: int, m: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Host packer: dense (N, K) (an array or a tensor, which keeps its
    device) -> (int8 values, int32 indices) for ``nm_spmm``."""
    vals, idx = nm_compress(torch.as_tensor(w), n_keep, m)
    return vals.to(torch.int8), idx
