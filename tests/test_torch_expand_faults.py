"""Non-canonical N:M slabs through the expand kernels' plain versions, held
against the JAX package's Pallas kernels in interpret mode: the semantics
the card kernels keep on slabs ``nm_compress`` never makes.

- Several slots naming one position: the expanded weight is their int32
  sum, which may leave int8, so the products leave the int16 keys' range.
  ``nm_sort_matmul`` under ``sorted`` and ``nm_chunked_sort_matmul`` (rows
  7 and 16) sort them as int32 keys (on the card: the radix route of
  ``csrc/nm_expand_sort.cu``).
- A slot whose index lies outside [0, m_group): the JAX one-hot expansion
  drops it, and so does ``nm_seq_policy_matmul`` (row 5; on the card its
  expand kernel's scatter).
- Pass 2 on merged slots (row 13's card kernel, ``nm_paired_accum_matmul``
  of ``csrc/nm_expand_sort.cu``): with at least one round a row's
  expanded weights are its merged slots (out-of-group slots dropped, the
  slots that name one position summed into the first of them), and each
  sorted dense tile is its merged products sorted, then zeros, so pass 2
  on the merged slots equals the JAX kernel on the expanded row; with no
  round the dense interleave is not the merged one, and the kernel keeps
  the expanded row. ``merged_pass2`` below is that algorithm in torch.

The card kernels are held against these plain versions by
tests/test_torch_cuda.py (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core.sorted_accum import pair_permutation as jpair_permutation
from repro.kernels import nm_spmm as jnm
from repro.kernels import sorted_stream as jss
from repro_torch.core.sorted_accum import (
    monotone_accumulate,
    paired_order,
    sorted_order,
)
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import sorted_stream as tss
from test_torch_nm_sort import _case, _t

BLOCKS = dict(bm=8, bn=8, interpret=True)


def _pad8(x, vals, idx, kp):
    """The JAX kernels' operands: x's rows and the slabs' rows padded to
    multiples of 8 with zeros, x's columns to kp."""
    m, k = x.shape
    n = vals.shape[0]
    jx = np.pad(x, ((0, -m % 8), (0, kp - k)))
    pad = ((0, -n % 8), (0, 0), (0, 0))
    return (jnp.asarray(jx), jnp.asarray(np.pad(vals, pad)),
            jnp.asarray(np.pad(idx, pad)))


def _stacked(vals, idx, x, m_group):
    """Every slot of every other group of the odd rows at the group's
    position 0 with value 127, and x 127 there: the position's weight is
    127 n_keep, its product 127^2 n_keep."""
    vals, idx, x = vals.copy(), idx.copy(), x.copy()
    vals[1::2, ::2] = 127
    idx[1::2, ::2] = 0
    x[:, ::2 * m_group] = 127
    return vals, idx, x


def test_expand_sorted_smallest_case_past_int16():
    """M = N = 1, K = 16, 3:16: three slots at position 0 with value 127 and
    x = 127 there. The key is 3 * 127 * 127 = 48387, which int16 keys would
    wrap (to -17149); the plain version and the JAX kernel keep it."""
    x = np.zeros((1, 16), np.int8)
    x[0, 0] = 127
    vals = np.full((1, 1, 3), 127, np.int8)
    idx = np.zeros((1, 1, 3), np.int32)
    kw = dict(m_group=16, policy="sorted", acc_bits=30, rounds=1)
    got = nm_spmm.nm_sort_matmul(*_t(x, vals, idx), **kw)
    assert got.tolist() == [[48387]]
    want = jnm.nm_sort_matmul(*_pad8(x, vals, idx, 16), **kw, **BLOCKS)
    assert np.asarray(want)[0, 0] == 48387


# (n_keep, m_group, K, acc_bits, rounds): each case one Pallas compile of
# each kernel
STACKED = ((3, 16, 300, 30, 1), (8, 16, 512, 16, 2), (3, 4, 192, 16, 3))


@pytest.mark.parametrize("case", STACKED, ids=str)
def test_expand_sorted_matches_pallas_past_int8(case):
    """Rows 7 (``nm_sort_matmul`` under ``sorted``) and 16
    (``nm_chunked_sort_matmul``) on slabs whose slots name one position
    several times, against the JAX kernels, which add them in int32."""
    n_keep, m_group, k, acc_bits, rounds = case
    x, _, vals, idx = _case(5, 9, k, n_keep, m_group, k + acc_bits)
    vals, idx, x = _stacked(vals, idx, x, m_group)
    kp = 1 << (vals.shape[1] * m_group - 1).bit_length()
    jargs = _pad8(x, vals, idx, kp)
    kw = dict(m_group=m_group, acc_bits=acc_bits, rounds=rounds)
    got = nm_spmm.nm_sort_matmul(*_t(x, vals, idx), policy="sorted", **kw)
    want = np.asarray(jnm.nm_sort_matmul(*jargs, policy="sorted", **kw,
                                         **BLOCKS))[:5, :9]
    np.testing.assert_array_equal(got.numpy(), want)
    chunked = tss.nm_chunked_sort_matmul(*_t(x, vals, idx), **kw)
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(
        jss.nm_chunked_sort_matmul(*jargs, bc=4, **kw, **BLOCKS))[:5, :9])
    # the sums leave int8: the case reaches keys past int16
    assert int(np.abs(x[:, ::2 * m_group].astype(np.int64) * 127 *
                      n_keep).max()) > 32767


@pytest.mark.parametrize("policy", ["clip", "sorted_tiled_seq"])
def test_expand_seq_drops_out_of_group_indices(policy):
    """Row 5 (``nm_seq_policy_matmul``) on slabs with indices m_group, -1
    and 2^20 in every third group: the JAX kernel's one-hot expansion drops
    those slots, and so does the plain version (equal to it on the slabs
    with those slots' values set to 0)."""
    m_group, n_keep, k = 16, 4, 256
    x, _, vals, idx = _case(8, 8, k, n_keep, m_group, 17)
    bad, dropped = idx.copy(), vals.copy()
    for j, (sl, i) in enumerate(((slice(0, None, 3), m_group),
                                 (slice(1, None, 3), -1),
                                 (slice(2, None, 3), 1 << 20))):
        bad[:, sl, j + 1] = i
        dropped[:, sl, j + 1] = 0
    assert (vals != dropped).any()
    kw = dict(m_group=m_group, policy=policy, acc_bits=12, rounds=1)
    want = np.asarray(jnm.nm_seq_policy_matmul(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(bad), **kw, bm=8,
        bn=8, bg=16, interpret=True))
    got = nm_spmm.nm_seq_policy_matmul(*_t(x, vals, bad), **kw, k_tile=256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), nm_spmm.nm_seq_policy_matmul(
        *_t(x, dropped, idx), **kw, k_tile=256).numpy())


def merged_slots(vals, idx, m_group, k):
    """Row 13's merged slots of (N, G, n_keep) slabs: (positions, weights),
    (N, G * n_keep) each. A slot of value 0, with an index outside [0,
    m_group) or at a position at or past k has weight 0; of the slots of
    a group that name one position the first has the int32 sum of their
    values, the others weight 0."""
    n, g, n_keep = vals.shape
    v, j = vals.to(torch.int32), idx.to(torch.int64)
    pos = j + torch.arange(g)[:, None] * m_group
    live = (v != 0) & (j >= 0) & (j < m_group) & (pos < k)
    same = (j[..., :, None] == j[..., None, :]) & live[..., :, None] \
        & live[..., None, :]
    earlier = torch.arange(n_keep)[None, :] < torch.arange(n_keep)[:, None]
    first = live & ~(same & earlier).any(-1)
    weight = torch.where(first, (same * v[..., None, :]).sum(-1), 0)
    return pos.reshape(n, -1), weight.reshape(n, -1).to(torch.int32)


def merged_pass2(x, vals, idx, perm, *, m_group, acc_bits, k_tile, rounds):
    """Pass 2 on compressed slabs from the merged slots (rounds >= 1): each
    k_tile tile is its lc = (k_tile / m_group) n_keep merged products,
    padded to a power of two, sorted, interleaved in perm's paired order,
    then added stepwise with saturation. With no round, the expanded row
    (``nm_paired_accum_matmul_ref``)."""
    if rounds == 0:
        return tss.nm_paired_accum_matmul_ref(
            x, vals, idx, perm, m_group=m_group, acc_bits=acc_bits,
            k_tile=k_tile, rounds=rounds)
    g = vals.shape[1]
    kp = g * m_group + (-g * m_group) % k_tile
    pos, w = merged_slots(vals, idx, m_group, x.shape[1])
    pad = kp // m_group * vals.shape[2] - w.shape[1]
    pos = torch.nn.functional.pad(pos, (0, pad))
    w = torch.nn.functional.pad(w, (0, pad))
    xk = torch.nn.functional.pad(x.to(torch.int32), (0, kp - x.shape[1]))
    prods = xk[:, pos] * w  # (M, N, kp / m_group * n_keep)
    tiles = nm_spmm.pad_last_pow2(prods.reshape(*prods.shape[:2],
                                                kp // k_tile, -1))
    ordered = paired_order(sorted_order(tiles, rounds), perm.long())
    return monotone_accumulate(ordered, acc_bits)[0]


def _non_canonical_pass2(vals, idx, m_group):
    """Descending in-group indices (each group's slots reversed), in every
    third group slot 0 at the last slot's position (a duplicate), in every
    fourth slot 1 at index m_group and in every eighth from the third at
    -1 (outside the group), and every slot of every fifth group at
    position 0 with value 127 (a merged weight of 127 n_keep)."""
    vals, idx = vals[..., ::-1].copy(), idx[..., ::-1].copy()
    idx[:, 1::3, 0] = idx[:, 1::3, -1]
    idx[:, ::4, 1] = m_group
    idx[:, 2::8, 1] = -1
    idx[:, ::5, :] = 0
    vals[:, ::5, :] = 127
    return vals, idx


@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_merged_slot_pass2_matches_pallas(rounds):
    """Row 13's merged-slot pass 2 (``merged_pass2``) on non-canonical
    slabs (duplicates, out-of-group slots, descending indices, merged
    weights past int8) against the JAX package's ``nm_paired_accum_matmul``
    in interpret mode, fed the JAX package's own pairing of the expanded
    tile sums; at rounds 1 and 2 the merged slots, at 0 the expanded row."""
    m_group, n_keep, k, k_tile = 16, 4, 512, 128
    x, _, vals, idx = _case(5, 9, k, n_keep, m_group, 29 + rounds)
    vals, idx = _non_canonical_pass2(vals, idx, m_group)
    x[:, ::5 * m_group] = 127
    jargs = _pad8(x, vals, idx, k)
    jsums = jss.nm_tile_sums_matmul(*jargs, m_group=m_group, k_tile=k_tile,
                                    **BLOCKS)
    jperm = jpair_permutation(jsums).astype(jnp.int32)
    kw = dict(m_group=m_group, acc_bits=16, k_tile=k_tile, rounds=rounds)
    want = np.asarray(jss.nm_paired_accum_matmul(*jargs, jperm, **kw,
                                                 **BLOCKS))[:5, :9]
    perm = torch.from_numpy(np.array(jperm)[:5, :9])
    got = merged_pass2(*_t(x, vals, idx), perm, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tss.nm_paired_accum_matmul(
        *_t(x, vals, idx), perm, **kw).numpy(), want)
    # the merged weights leave int8
    assert int(merged_slots(*_t(vals, idx), m_group, k)[1].abs().max()) > 127
