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

And the premise of the card's pass 2 (``csrc/pass2.cuh``, rows 12 and 14):
with at least one round, a pair slot may keep only its two tiles' nonzero
products, pad both to next_pow2 of the larger count and sort those
(``_compacted_pass2``, a torch model of it), held against the JAX
package's ``paired_accum_matmul`` in interpret mode; with no round the
compacted interleave differs, which is why that route stays dense.
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
from repro.kernels import sorted_stream as jss
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


PASS2_TILE = 256
# (tile, nonzero products) of the constructed rows of w in
# _pass2_operands: rows 4-7 hold tiles of exactly 64, 65, 128, 129 and 256
# nonzero products against row 2 of x, which has no zero
PASS2_NNZ = ((64, 65, 128), (129, 64, 65), (128, 129, 256), (65, 0, 129))


def _pass2_operands(pruned, seed):
    """Seeded int8 x (4, 768) and w (8, 768), three tiles of 256 (an odd
    T): row 0 of x saturating, row 1 all zero, row 2 without a zero; w
    8:16-pruned by the JAX mask, or unpruned with rows 4-7 built to the
    nonzero counts of ``PASS2_NNZ``."""
    r = np.random.default_rng(seed)
    k = 3 * PASS2_TILE
    x = r.integers(-128, 128, (4, k)).astype(np.int8)
    w = r.integers(-127, 128, (8, k))
    x[0] = 127
    w[0, : k // 2] = 127
    x[1] = 0
    x[2] = r.integers(1, 128, k) * np.where(r.random(k) < 0.5, -1, 1)
    if pruned:
        mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(w, jnp.float32),
                                            N_KEEP, M_GROUP))
        return x, (w * mask).astype(np.int8)
    w[w == 0] = 1
    for row, counts in zip(range(4, 8), PASS2_NNZ):
        for t, nnz in enumerate(counts):
            tile = w[row, t * PASS2_TILE:(t + 1) * PASS2_TILE]
            tile[r.permutation(PASS2_TILE)[nnz:]] = 0
    return x, w.astype(np.int8)


def _perm(x, w, k_tile):
    """The JAX package's pairing of the tile sums of x against w."""
    m, k = x.shape
    sums = (x.astype(np.int64)[:, None, :] * w.astype(np.int64)[None]
            ).reshape(m, w.shape[0], k // k_tile, k_tile).sum(-1)
    return np.asarray(jsa.pair_permutation(jnp.asarray(sums, jnp.int32)))


def _compacted_pass2(x, w, perm, k_tile, rounds, acc_bits):
    """A torch model of the card's compacted pass 2: each pair slot keeps
    its two tiles' nonzero products, pads both with zeros to L =
    next_pow2(the larger count), sorts each ``rounds`` rounds and
    interleaves them; the slots' streams in perm's order are added with
    one saturating add each."""
    m, k = x.shape
    n, t = w.shape[0], k // k_tile
    prods = (torch.from_numpy(x).long()[:, None, :]
             * torch.from_numpy(w).long()[None]).reshape(m, n, t, k_tile)
    streams = torch.zeros((m, n, (t + 1) // 2 * 2 * k_tile),
                          dtype=torch.int64)
    for i in range(m):
        for j in range(n):
            order, pieces = perm[i, j].tolist(), []
            for s in range(0, t, 2):
                a = prods[i, j, order[s]]
                b = (prods[i, j, order[s + 1]] if s + 1 < t
                     else torch.zeros(k_tile, dtype=torch.int64))
                a, b = a[a != 0], b[b != 0]
                size = 1 << (max(len(a), len(b), 1) - 1).bit_length()
                sa, sb = (tsa.sorted_order(torch.nn.functional.pad(
                    v, (0, size - len(v))), rounds) for v in (a, b))
                pieces.append(torch.stack([sa, sb], -1).reshape(-1))
            stream = torch.cat(pieces)
            streams[i, j, : len(stream)] = stream
    return tsa.monotone_accumulate(streams, acc_bits)[0].numpy()


@pytest.mark.parametrize("pruned", [True, False], ids=["8:16", "dense"])
@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_pass2_sorts_nonzero_products(pruned, rounds):
    """With rounds 1 to 3, on an 8:16-pruned and an unpruned weight (tiles
    of exactly 64, 65, 128, 129 and 256 nonzero products, an all-zero row
    of x, three tiles a row), ``_compacted_pass2`` equals the JAX
    package's ``paired_accum_matmul`` in interpret mode, bit for bit."""
    x, w = _pass2_operands(pruned, 40 + rounds)
    perm = _perm(x, w, PASS2_TILE)
    if not pruned:
        nnz = (x[2].astype(np.int64) * w[4:8]).reshape(
            4, 3, PASS2_TILE) != 0
        assert nnz.sum(-1).tolist() == [list(c) for c in PASS2_NNZ]
    acc_bits = 12 if rounds == 2 else 16  # one Pallas compile a case
    want = np.asarray(jss.paired_accum_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(perm),
        acc_bits=acc_bits, k_tile=PASS2_TILE, rounds=rounds, **BLOCKS))
    np.testing.assert_array_equal(
        _compacted_pass2(x, w, perm, PASS2_TILE, rounds, acc_bits), want)


def test_pass2_without_a_round_stays_dense():
    """With no round the tiles keep their positions, and the dense
    interleave is not the compacted one: two tiles (100, 100, 0, 0) and
    (0, 0, -100, -100) add as 100, 0, 100, 0, 0, -100, 0, -100 (-73 in an
    8-bit register) against the compacted 100, -100, 100, -100 (0). With
    a round the two agree (the JAX package's kernel gives both)."""
    x = np.zeros((4, 8), np.int8)
    w = np.zeros((8, 8), np.int8)
    x[0] = 10
    w[0] = (10, 10, 0, 0, 0, 0, -10, -10)
    perm = np.tile(np.arange(2, dtype=np.int32), (4, 8, 1))
    for rounds in (0, 1):
        want = np.asarray(jss.paired_accum_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(perm), acc_bits=8,
            k_tile=4, rounds=rounds, **BLOCKS))
        got = _compacted_pass2(x, w, perm, 4, rounds, 8)
        if rounds:
            np.testing.assert_array_equal(got, want)
        else:
            assert (want[0, 0], got[0, 0]) == (-73, 0)
            np.testing.assert_array_equal(got[1:], want[1:])
