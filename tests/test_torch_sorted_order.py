"""The premise that lets the card's global-sort kernels sort their keys in
any order: a sort's result does not depend on where each key starts.

Under ``sorted`` the one-pass ``sort_matmul`` and ``nm_gather_sort_matmul``
are unchanged by a permutation of K applied to x and w together (for the
compressed weight: of the groups, applied to x's groups and the slabs'
groups together); under ``sorted_tiled`` by a permutation inside each k_tile
tile. So the CUDA bodies may read a stream in whatever layout loads fastest
(``csrc/pqs_accum.cuh`` ``sorted_dot`` reads it coalesced, position r * 32 W
+ t in register r of thread t). On the CPU each wrapper runs its plain
version; each case is held against the JAX package's Pallas kernel in
interpret mode on the unpermuted operands.

And the premise of the card's radix `sorted` body (``csrc/pqs_accum.cuh``
``radix_sorted_dot``): with at least one round, the nonzero stream of
``sorted_order`` does not depend on how many zero keys pad the row, so the
body sorts only the real keys, drops the zeros and pairs the m sorted
nonzero keys as max(s[i], 0) + min(s[m-1-i], 0) (``_radix_order``, a numpy
model of it), held against the JAX package's ``sorted_order``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core import pruning as jpr
from repro.core import sorted_accum as jsa
from repro.kernels import nm_spmm as jnm
from repro.kernels import sorted_matmul as jsm
from repro_torch.core import sorted_accum as tsa
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import sorted_matmul as tsm

BLOCKS = dict(bm=4, bn=8, interpret=True)
M_GROUP, N_KEEP = 16, 8
# (policy, storage, K, k_tile, acc_bits, rounds for the JAX kernel): each
# case one Pallas compile
CASES = (("sorted", "dense", 128, 1, 12, 2),
         ("sorted", "gather", 256, 1, 16, 1),
         ("sorted_tiled", "dense", 256, 64, 12, 1),
         ("sorted_tiled", "gather", 256, 64, 16, 2))


def _operands(k, seed):
    """Seeded int8 x (8, k) and an (8, k) weight pruned 8:16 by the JAX
    mask, with its slabs: row 0 saturating, row 1 of x all zero."""
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (8, k)).astype(np.int8)
    w = r.integers(-127, 128, (8, k))
    x[0] = 127
    w[0, : k // 2] = 127
    x[1] = 0
    mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(w, jnp.float32), N_KEEP,
                                        M_GROUP))
    w = (w * mask).astype(np.int8)
    vals, idx = jpr.nm_compress(w, N_KEEP, M_GROUP)
    return x, w, np.asarray(vals), np.asarray(idx)


def _group_perm(k, k_tile, seed):
    """A permutation of the k / M_GROUP groups: any, or (k_tile > 1) one
    inside each tile of k_tile / M_GROUP groups."""
    r = np.random.default_rng(seed)
    g = k // M_GROUP
    if k_tile <= 1:
        return r.permutation(g)
    per = k_tile // M_GROUP
    return np.concatenate([t * per + r.permutation(per)
                           for t in range(g // per)])


def _run(policy, storage, x, w, vals, idx, k_tile, acc_bits, rounds):
    kw = dict(policy=policy, acc_bits=acc_bits, rounds=rounds)
    if policy == "sorted_tiled":
        kw["k_tile"] = k_tile
    if storage == "dense":
        return tsm.sort_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               **kw).numpy()
    return nm_spmm.nm_gather_sort_matmul(
        torch.from_numpy(x), torch.from_numpy(vals), torch.from_numpy(idx),
        m_group=M_GROUP, **kw).numpy()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_sort_result_does_not_depend_on_key_order(case):
    policy, storage, k, k_tile, acc_bits, jrounds = case
    x, w, vals, idx = _operands(k, k + acc_bits)
    kw = dict(policy=policy, acc_bits=acc_bits, rounds=jrounds)
    if policy == "sorted_tiled":
        kw["k_tile"] = k_tile
    if storage == "dense":
        want = np.asarray(jsm.sort_matmul(jnp.asarray(x), jnp.asarray(w),
                                          **kw, **BLOCKS))
    else:
        want = np.asarray(jnm.nm_gather_sort_matmul(
            jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx),
            m_group=M_GROUP, **kw, **BLOCKS))
    for seed in (1,):
        # positions: a permutation of K (sorted) or inside each tile,
        # taken group by group and then inside each group
        gp = _group_perm(k, k_tile, seed)
        inner = np.random.default_rng(seed + 10).permutation(M_GROUP)
        pos = (gp[:, None] * M_GROUP + inner[None, :]).reshape(-1)
        # the slabs follow their groups; a group's kept slots keep their
        # in-group indices, remapped through the inner permutation
        where = np.argsort(inner)
        pidx = where[idx[:, gp]].astype(np.int32)
        pvals = vals[:, gp]
        for rounds in (1, 2, 3):
            base = _run(policy, storage, x, w, vals, idx, k_tile, acc_bits,
                        rounds)
            got = _run(policy, storage, np.ascontiguousarray(x[:, pos]),
                       np.ascontiguousarray(w[:, pos]),
                       np.ascontiguousarray(pvals),
                       np.ascontiguousarray(pidx), k_tile, acc_bits, rounds)
            np.testing.assert_array_equal(got, base)
            if rounds == jrounds:
                np.testing.assert_array_equal(got, want)


def _nonzero(a):
    return a[a != 0]


def _radix_order(keys, rounds):
    """The card's radix body in numpy: each round drops the zero keys,
    sorts the m others descending and pairs them, out[i] = max(s[i], 0) +
    min(s[m-1-i], 0)."""
    s = keys
    for _ in range(rounds):
        s = np.sort(s[s != 0])[::-1]
        s = np.maximum(s, 0) + np.minimum(s[::-1], 0)
    return s


@pytest.mark.parametrize("zeros", [0.0, 0.3, 0.9])
def test_nonzero_stream_does_not_depend_on_zero_padding(zeros):
    """For K from 1 to 300, rounds 1 to 3 and rows padded with zeros to
    next_pow2(K) and to twice that, the nonzero stream of the order is the
    same: the port's ``sorted_order`` on every padding, the JAX package's
    on the power-of-two one, and ``_radix_order`` on the unpadded row."""
    r = np.random.default_rng(int(zeros * 10) + 3)
    ks = list(range(1, 41)) + [63, 64, 65, 127, 128, 255, 256, 300]
    for k in ks:
        keys = (r.integers(-128, 128, k) * r.integers(-128, 128, k)).astype(
            np.int32)
        keys[r.random(k) < zeros] = 0
        if k % 7 == 0:  # heavy ties
            keys = np.where(keys != 0, np.sign(keys) * 5, 0).astype(np.int32)
        p2 = 1 << max(k - 1, 0).bit_length()
        rows = [np.pad(keys, (0, pad)) for pad in (0, p2 - k, 2 * p2 - k)]
        for rounds in (1, 2, 3):
            want = _nonzero(np.asarray(jsa.sorted_order(jnp.asarray(rows[1]),
                                                         rounds)))
            for row in rows:
                got = tsa.sorted_order(torch.from_numpy(row), rounds).numpy()
                np.testing.assert_array_equal(_nonzero(got), want)
            np.testing.assert_array_equal(_nonzero(_radix_order(keys,
                                                                rounds)),
                                          want)
