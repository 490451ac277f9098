"""A slot whose gathered position lies before x's row, through the gather
kernels' plain versions, held against the JAX package's Pallas kernels in
interpret mode.

Slot j of group g gathers x at g * m_group + idx; nothing stops an index
below -g * m_group on slabs ``nm_compress`` never makes. The JAX kernels
gather with ``take_along_axis`` on their x block: a position in [-n, 0)
wraps from the block's end, one below -n reads a fill value. The port's
rule (``nm_spmm.gather_nm_products``): x zero-extended to a width W, a
position in [-W, 0) read at position + W, one below -W or at or past W a
zero product; W is the padded K (kp) of the global-sort kernels and
G * m_group for the K-streaming one.

- ``nm_gather_sort_matmul`` (both policies), ``nm_gather_paired_accum_matmul``
  and ``nm_gather_chunked_sort_matmul``: the JAX x block is the whole row of
  kp (the caller's padded K), so its result depends on no block shape and
  the plain versions equal it.
- ``nm_gather_seq_policy_matmul`` (x blocks of bg groups) and
  ``nm_gather_tile_sums`` (x blocks of one k_tile tile): the JAX result
  depends on the block, which the port does not carry over; they equal it
  where the block is the whole row (bg = G, k_tile = kp).

The card kernels (rows 6, 8, 11, 14 and 17) are held against these plain
versions by tests/test_torch_cuda.py (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core.sorted_accum import pair_permutation as jpair_permutation
from repro.kernels import nm_spmm as jnm
from repro.kernels import sorted_stream as jss
from repro_torch.core.sorted_accum import pair_permutation
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import sorted_stream as tss
from test_torch_nm_sort import _t

M_GROUP, N_KEEP = 16, 2
ONE = dict(bm=1, bn=1, interpret=True)


def _negative(groups, seed, index=-20):
    """M = N = 1, K = groups * 16, 2:16 slabs canonical but for slot 1 of
    group 1, whose index (default -20: position -4) lies before the row;
    x nonzero everywhere."""
    r = np.random.default_rng(seed)
    k = groups * M_GROUP
    x = r.integers(1, 128, (1, k)).astype(np.int8)
    x[0, 1::2] *= -1
    vals = r.integers(1, 128, (1, groups, N_KEEP)).astype(np.int8)
    idx = np.tile(np.array([3, 11], np.int32), (1, groups, 1))
    idx[0, 1, 1] = index
    return x, vals, idx


def _jax_x(x, kp):
    return jnp.asarray(np.pad(x, ((0, 0), (0, kp - x.shape[1]))))


def _calls(kernel, x, vals, idx, acc_bits=16, rounds=1):
    """[(port plain version, JAX kernel or None)] of ``kernel`` on one
    case: JAX operands as its callers pad them (x to kp), x blocks the
    whole row; ``sorted_tiled`` on tiles of one group, pass 2 on tiles of
    half the row (G even) and ``sorted_tiled_seq`` on one tile of the row
    (G a power of two)."""
    g = vals.shape[1]
    tx, tv, ti = _t(x, vals, idx)
    jx, jv, ji = jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx)
    kw = dict(m_group=M_GROUP, acc_bits=acc_bits, rounds=rounds)
    width = g * M_GROUP
    kp = 1 << (width - 1).bit_length()  # `sorted`'s padded K
    if kernel == "nm_gather_seq_policy_matmul":
        calls = [(lambda: nm_spmm.nm_gather_seq_policy_matmul(
            tx, tv, ti, policy="clip", **kw),
            lambda: jnm.nm_gather_seq_policy_matmul(
                jx, jv, ji, policy="clip", bg=g, **kw, **ONE))]
        if width == kp:
            calls.append((lambda: nm_spmm.nm_gather_seq_policy_matmul(
                tx, tv, ti, policy="sorted_tiled_seq", k_tile=width, **kw),
                lambda: jnm.nm_gather_seq_policy_matmul(
                    jx, jv, ji, policy="sorted_tiled_seq", bg=g, **kw,
                    **ONE)))
        return calls
    if kernel == "nm_gather_sort_matmul":
        tk = dict(kw, k_tile=M_GROUP)
        return [(lambda: nm_spmm.nm_gather_sort_matmul(
            tx, tv, ti, policy="sorted", **kw),
            lambda: jnm.nm_gather_sort_matmul(_jax_x(x, kp), jv, ji,
                                              policy="sorted", **kw, **ONE)),
            (lambda: nm_spmm.nm_gather_sort_matmul(
                tx, tv, ti, policy="sorted_tiled", **tk),
             lambda: jnm.nm_gather_sort_matmul(
                 jx, jv, ji, policy="sorted_tiled", **tk, **ONE))]
    if kernel == "nm_gather_tile_sums":
        return [(lambda: tss.nm_gather_tile_sums(
            tx, tv, ti, m_group=M_GROUP, k_tile=width),
            lambda: jss.nm_gather_tile_sums(jx, jv, ji, m_group=M_GROUP,
                                            k_tile=width, **ONE))]
    if kernel == "nm_gather_paired_accum_matmul":
        tk = dict(kw, k_tile=width // 2)
        sums = tss.nm_gather_tile_sums(tx, tv, ti, m_group=M_GROUP,
                                       k_tile=width // 2)
        perm = pair_permutation(sums).to(torch.int32)
        jperm = jpair_permutation(jnp.asarray(sums.numpy()))
        return [(lambda: tss.nm_gather_paired_accum_matmul(
            tx, tv, ti, perm, **tk),
            lambda: jss.nm_gather_paired_accum_matmul(
                jx, jv, ji, jperm.astype(jnp.int32), **tk, **ONE))]
    assert kernel == "nm_gather_chunked_sort_matmul"
    return [(lambda: tss.nm_gather_chunked_sort_matmul(tx, tv, ti, **kw),
             lambda: jss.nm_gather_chunked_sort_matmul(
                 _jax_x(x, kp), jv, ji, bc=1, **kw, **ONE))]


def _port(kernel, x, vals, idx, **kw):
    return [port().numpy() for port, _ in _calls(kernel, x, vals, idx, **kw)]


def _held(kernel, x, vals, idx, **kw):
    """The port's results, each asserted equal to the JAX kernel's."""
    out = []
    for port, jax_kernel in _calls(kernel, x, vals, idx, **kw):
        got = port().numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_kernel()))
        out.append(got)
    return out


GATHER_KERNELS = ("nm_gather_seq_policy_matmul", "nm_gather_sort_matmul",
                  "nm_gather_tile_sums", "nm_gather_paired_accum_matmul",
                  "nm_gather_chunked_sort_matmul")


@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_negative_position_smallest_case(kernel):
    """M = N = 1, two groups, slot 1 of group 1 at index -20 (position -4):
    each gather plain version reads x at position 28 of the 32-wide row,
    as the JAX kernel does (its x block the whole row), and differs from
    the same slabs with that slot's value set to 0."""
    x, vals, idx = _negative(2, 3)
    got = _held(kernel, x, vals, idx)
    dropped = vals.copy()
    dropped[0, 1, 1] = 0
    assert any(not np.array_equal(g, a)
               for g, a in zip(got, _port(kernel, x, dropped, idx)))


@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_negative_position_wraps_within_padded_k(kernel):
    """Three groups (K = 48), rounds 2, acc_bits 12: the `sorted` kernels'
    padded K is 64, so position -4 reads the zero at 60 of the padded row,
    as the JAX kernels (x padded to kp) do; the others wrap within 48 (x at
    44). Pass 1 and pass 2, whose tiles are powers of two, take four
    groups."""
    groups = 4 if kernel in ("nm_gather_tile_sums",
                             "nm_gather_paired_accum_matmul") else 3
    x, vals, idx = _negative(groups, 5)
    _held(kernel, x, vals, idx, acc_bits=12, rounds=2)


@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_position_below_padded_row_is_zero(kernel):
    """An index of -85 in group 1 (position -69, below -64, the widest row
    here): the port's rule makes it a zero product (the JAX kernels read a
    fill value there), so every gather plain version equals the same slabs
    with that slot's value 0."""
    x, vals, idx = _negative(2, 7, index=-85)
    dropped = vals.copy()
    dropped[0, 1, 1] = 0
    for got, alone in zip(_port(kernel, x, vals, idx),
                          _port(kernel, x, dropped, idx)):
        np.testing.assert_array_equal(got, alone)
