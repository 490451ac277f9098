"""Pass 1 of the two-pass ``sorted_tiled`` in the port, against the JAX
package, bit-exact: the tile sums of dense weights (``tile_sums_matmul``)
and of the kept products of N:M slabs (``nm_gather_tile_sums``).

On the CPU each wrapper runs its plain version; each is held against the
JAX package's Pallas kernel run in interpret mode on the same numpy-seeded
operands (zero-padded to its blocks of 8 x 8): at M 1 and 5, k_tile 16, 64
and 1024, 8:16 and 2:4 slabs, canonical and non-canonical (unsorted
in-group indices and duplicate ones, whose products are both gathered),
and at the int8 extremes, where a tile sum reaches 2^24. The expand twin
(``nm_tile_sums_matmul``) is held to the JAX package's on slabs with
indices outside their groups (dropped) and duplicate slots whose sum
leaves int8 (added in int32). Integer results, so the tolerance is 0.
The CUDA bodies (the int8 mainloop and the small-tile body of row 9; the
few-rows and many-rows bodies that rows 10 and 11 share, and row 10's
one-warp body for longer tiles) are held against these plain versions on
the card by tests/test_torch_cuda.py (marker ``cuda``) and
``chip_smoke.py`` phase 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core import pruning as jpr
from repro.kernels import sorted_stream as jss
from repro_torch.kernels import sorted_stream as tss

BLOCKS = dict(bm=8, bn=8, interpret=True)
N = 8  # output columns: one JAX block


def _rows8(x):
    """x zero-padded to a multiple of 8 rows (the JAX kernels' blocks)."""
    return np.pad(x, ((0, (-x.shape[0]) % 8), (0, 0)))


def _dense(m, k, seed):
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-128, 128, (N, k)).astype(np.int8)
    return x, w


def _check_dense(x, w, k_tile):
    want = np.asarray(jss.tile_sums_matmul(
        jnp.asarray(_rows8(x)), jnp.asarray(w), k_tile=k_tile,
        **BLOCKS))[: x.shape[0]]
    got = tss.tile_sums_matmul(torch.from_numpy(x), torch.from_numpy(w),
                               k_tile=k_tile)
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("k_tile", [16, 64, 1024])
def test_tile_sums_matches_pallas(m, k_tile):
    x, w = _dense(m, 2048, m * k_tile)
    _check_dense(x, w, k_tile)


def test_tile_sums_int8_extremes_reach_2_24():
    """x all -128 against weight rows all -128 and all 127, k_tile 1024:
    tile sums of exactly 2^24 and -128 * 127 * 1024."""
    x = np.full((5, 2048), -128, np.int8)
    w = np.full((N, 2048), 127, np.int8)
    w[: N // 2] = -128
    got = _check_dense(x, w, 1024)
    assert int(got.max()) == 1 << 24
    assert int(got.min()) == -128 * 127 * 1024


def _slabs(m, n_keep, m_group, seed, k=2048):
    """Seeded x (m, k) and the n_keep:m_group slabs of an (N, k) weight
    pruned by the JAX mask."""
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-127, 128, (N, k))
    mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(w, jnp.float32), n_keep,
                                        m_group))
    vals, idx = jpr.nm_compress((w * mask).astype(np.int8), n_keep, m_group)
    return x, np.asarray(vals), np.asarray(idx)


def _non_canonical(vals, idx):
    """Each group's slots reversed (unsorted indices), and in every third
    group slot 0 at the last slot's position (a duplicate)."""
    vals = np.ascontiguousarray(vals[..., ::-1])
    idx = np.ascontiguousarray(idx[..., ::-1])
    idx[:, 1::3, 0] = idx[:, 1::3, -1]
    return vals, idx


def _check_gather(x, vals, idx, m_group, k_tile):
    want = np.asarray(jss.nm_gather_tile_sums(
        jnp.asarray(_rows8(x)), jnp.asarray(vals), jnp.asarray(idx),
        m_group=m_group, k_tile=k_tile, **BLOCKS))[: x.shape[0]]
    got = tss.nm_gather_tile_sums(*(torch.from_numpy(a)
                                    for a in (x, vals, idx)),
                                  m_group=m_group, k_tile=k_tile)
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("n_keep,m_group", [(8, 16), (2, 4)])
@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("k_tile", [16, 64, 1024])
def test_gather_tile_sums_matches_pallas(n_keep, m_group, m, k_tile):
    """Canonical slabs, and the same slabs made non-canonical, whose
    duplicate slots the JAX gather adds twice as well."""
    x, vals, idx = _slabs(m, n_keep, m_group, 7 * m + k_tile + n_keep)
    _check_gather(x, vals, idx, m_group, k_tile)
    nv, ni = _non_canonical(vals, idx)
    assert (np.diff(ni, axis=-1) <= 0).any()
    _check_gather(x, nv, ni, m_group, k_tile)


def test_gather_tile_sums_int8_extremes_reach_2_24():
    """16:16 slabs (every position kept) of weight rows all -128 and all
    127 against x all -128, k_tile 1024: the dense sums, up to 2^24."""
    x = np.full((5, 2048), -128, np.int8)
    w = np.full((N, 2048), 127, np.int8)
    w[: N // 2] = -128
    vals = w.reshape(N, 128, 16)
    idx = np.broadcast_to(np.arange(16, dtype=np.int32), vals.shape).copy()
    got = _check_gather(x, vals, idx, 16, 1024)
    np.testing.assert_array_equal(got.numpy(), tss.tile_sums_matmul(
        torch.from_numpy(x), torch.from_numpy(w), k_tile=1024).numpy())
    assert int(got.max()) == 1 << 24


def test_pass1_body_choice():
    """Row 9 runs on the mainloop for tiles of whole 64-byte slabs (a
    power-of-two count), else on its small-tile body; row 11 splits slots
    over lanes up to 16 rows of x."""
    assert [tss.tile_sums_body(t, 8960) for t in (1, 16, 32, 64, 128, 256,
                                                  512, 1024, 2048)] == [
        "small"] * 3 + ["mma"] * 6
    assert tss.tile_sums_body(192, 8960) == "small"  # 3 slabs
    assert tss.tile_sums_body(256, 0) == "small"  # K = 0: nothing to add
    assert [tss.nm_tile_sums_body(m) for m in (1, 4, 16, 17, 128)] == [
        "few_rows"] * 3 + ["many_rows"] * 2


def _off_group(vals, idx, m_group):
    """Non-canonical slabs the expand twin must hold to the JAX one-hot
    expansion: indices outside [0, m_group) (m_group + 1, -1 and 2^20,
    whose slots add nothing) and, in two groups, two nonzero slots at one
    position whose sum leaves int8 (+-200, added in int32)."""
    vals, idx = vals.copy(), idx.copy()
    idx[:, 2, 0], idx[:, 5, -1], idx[:, 7, 0] = m_group + 1, -1, 1 << 20
    for g, v in ((1, 100), (3, -100)):
        idx[:, g, 1] = idx[:, g, 0]
        vals[:, g, :2] = v
    return vals, idx


def _check_expand(x, vals, idx, m_group, k_tile):
    want = np.asarray(jss.nm_tile_sums_matmul(
        jnp.asarray(_rows8(x)), jnp.asarray(vals), jnp.asarray(idx),
        m_group=m_group, k_tile=k_tile, **BLOCKS))[: x.shape[0]]
    got = tss.nm_tile_sums_matmul(*(torch.from_numpy(a)
                                    for a in (x, vals, idx)),
                                  m_group=m_group, k_tile=k_tile)
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("n_keep,m_group", [(8, 16), (2, 4)])
@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("k_tile", [16, 1024])
def test_expand_tile_sums_matches_pallas_off_group(n_keep, m_group, m,
                                                   k_tile):
    """Row 10's plain version against the JAX package's Pallas
    ``nm_tile_sums_matmul`` (interpret mode) on slabs with indices outside
    their groups, which the expansion drops, and with duplicate nonzero
    slots whose sum leaves int8, which it adds in int32: the semantics the
    card kernel keeps. On canonical slabs it equals the gather twin."""
    x, vals, idx = _slabs(m, n_keep, m_group, 11 * m + k_tile + n_keep)
    canon = _check_expand(x, vals, idx, m_group, k_tile)
    np.testing.assert_array_equal(canon.numpy(), tss.nm_gather_tile_sums(
        *(torch.from_numpy(a) for a in (x, vals, idx)), m_group=m_group,
        k_tile=k_tile).numpy())
    ov, oi = _off_group(vals, idx, m_group)
    got = _check_expand(x, ov, oi, m_group, k_tile)
    dropped = ov.copy()
    dropped[(oi < 0) | (oi >= m_group)] = 0
    np.testing.assert_array_equal(got.numpy(), _check_expand(
        x, dropped, np.clip(oi, 0, m_group - 1), m_group, k_tile).numpy())
    assert not np.array_equal(got.numpy(), canon.numpy())


def test_expand_tile_sums_body_choice():
    """Row 10 runs row 11's body (few rows, many rows) at every tile that
    body stages, up to 1024 positions, and its one-warp body above; no
    power-of-two tile is refused."""
    assert [tss.nm_expand_tile_sums_body(m, 256) for m in (1, 16, 17, 128)
            ] == ["few_rows"] * 2 + ["many_rows"] * 2
    assert [tss.nm_expand_tile_sums_body(4, t) for t in (16, 1024, 2048,
                                                        8192)] == [
        "few_rows"] * 2 + ["warp"] * 2
    assert tss.nm_expand_tile_sums_body(128, 2048) == "warp"


def test_gather_tile_sums_cpu_takes_any_tile():
    """The card kernel stages tiles of up to 1024 positions; on the CPU the
    plain version takes any k_tile, as before."""
    x, vals, idx = _slabs(3, 8, 16, 5, k=4096)
    t = [torch.from_numpy(a) for a in (x, vals, idx)]
    got = tss.nm_gather_tile_sums(*t, m_group=16, k_tile=2048)
    halves = tss.nm_gather_tile_sums(*t, m_group=16, k_tile=1024)
    np.testing.assert_array_equal(
        got.numpy(), halves.reshape(3, N, 2, 2).sum(-1).numpy())
