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

The card kernels are held against these plain versions by
tests/test_torch_cuda.py (marker ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.kernels import nm_spmm as jnm
from repro.kernels import sorted_stream as jss
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
