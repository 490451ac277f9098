"""The port's overflow census, transient survivors, quantized-matmul
simulation, Algorithm 1 and pruning extras against the JAX package's.

Each test draws its inputs with numpy from a seed and feeds the same
arrays to ``repro`` (JAX, on the CPU) and ``repro_torch`` (torch, CPU).
Every integer result is compared bit-exact. Floats enter only in the
pruning baselines: ``filter_prune_mask`` is compared exactly on rows of
distinct norms, ``low_rank_approx`` by its reconstruction at rtol 1e-4 /
atol 1e-5 (U, S and Vᵀ differ by free signs between SVD routines), and
``sparsity`` exactly (a mean of 0/1 values in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import overflow as jov
from repro.core import pruning as jpr
from repro.core import sorted_accum as jsa
from repro_torch.core import overflow as tov
from repro_torch.core import pruning as tpr
from repro_torch.core import sorted_accum as tsa


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _prods(seed, shape, lo=-128, hi=128):
    """int32 partial products of int8 draws, int8 corners mixed in."""
    r = np.random.default_rng(seed)
    a, b = r.integers(lo, hi, shape), r.integers(-128, 128, shape)
    corners = np.array([-128, -127, 127, 0])
    a = np.where(r.random(shape) < 0.2, r.choice(corners, shape), a)
    return (a * b).astype(np.int32)


def _census_eq(t, j):
    for field in tov.Census._fields:
        assert int(getattr(t, field)) == int(getattr(j, field)), field


@pytest.mark.parametrize("acc_bits", [9, 12, 14, 16, 20])
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 48), (200,)])
def test_census_matches_jax(acc_bits, shape):
    """Every count, on batches with persistent, transient and clean dots
    (post-ReLU activations drive the transients), any leading dims."""
    prods = _prods(acc_bits + len(shape), shape, lo=0)
    c = tov.census(torch.from_numpy(prods), acc_bits)
    assert all(v.dtype == torch.int32 for v in c)
    _census_eq(c, jov.census(jnp.asarray(prods), acc_bits))


def test_census_running_sum_wraps_as_jax():
    """A running sum that leaves int32 wraps in both (torch.cumsum of
    int32 would widen to int64 without dtype=): the wrapped prefix is
    negative, so the final fits and the dot counts as transient."""
    prods = np.array([[2**31 - 1, 5, -(2**31 - 1), -3]], np.int32)
    c = tov.census(torch.from_numpy(prods), 16)
    _census_eq(c, jov.census(jnp.asarray(prods), 16))
    assert int(c.n_transient) == 1


def test_census_default_combine_field():
    c = tov.Census(*(torch.tensor(0),) * 4)
    assert c.n_combine == 0 and jov.Census(*(0,) * 4).n_combine == 0


@pytest.mark.parametrize("n_keep,m_group", [(8, 16), (2, 4), (3, 16)])
def test_nm_partial_products_match_jax(n_keep, m_group):
    """Kept-only products equal the JAX package's, a short x (K below
    G * m) zero-extended, and their census equals the dense census."""
    r = np.random.default_rng(n_keep * 31 + m_group)
    n, k = 6, 5 * m_group - 3
    w = r.integers(-128, 128, (n, k)).astype(np.int8)
    mask = np.asarray(jpr.nm_prune_mask(
        jnp.asarray(np.pad(w, ((0, 0), (0, 3))), jnp.float32), n_keep,
        m_group))[:, :k]
    w = (w * mask).astype(np.int8)
    vals, idx = jpr.nm_compress(w, n_keep, m_group)
    x = r.integers(0, 128, (4, k)).astype(np.int32)
    t = tov.nm_partial_products(torch.from_numpy(vals), torch.from_numpy(idx),
                                torch.from_numpy(x), m_group)
    j = jov.nm_partial_products(jnp.asarray(vals), jnp.asarray(idx),
                                jnp.asarray(x), m_group)
    assert t.dtype == torch.int32
    _eq(t, j)
    dense = tov.partial_products(torch.from_numpy(w), torch.from_numpy(x))
    _census_eq(tov.census(t, 12), tov.census(dense, 12))


@pytest.mark.parametrize("policy", ["natural", "sorted", "sorted_tiled",
                                    "sorted_tiled_seq"])
@pytest.mark.parametrize("rounds", [1, 2])
def test_transient_survivors_match_jax(policy, rounds):
    prods = _prods(rounds * 7 + len(policy), (48, 128), lo=0)
    kw = dict(policy=policy, k_tile=32, rounds=rounds)
    for acc_bits in (14, 16):
        t = tov.transient_survivors(torch.from_numpy(prods), acc_bits, **kw)
        assert t.dtype == torch.int32
        assert int(t) == int(jov.transient_survivors(jnp.asarray(prods),
                                                     acc_bits, **kw))
    assert int(tov.transient_survivors(torch.from_numpy(prods), 14,
                                       policy="natural")) > 0


def test_transient_survivors_refuses_unknown_policy():
    with pytest.raises(ValueError, match="unknown policy"):
        tov.transient_survivors(torch.zeros((1, 4), dtype=torch.int32), 16,
                                policy="clip")
    with pytest.raises(ValueError, match="unknown policy"):
        tov.accumulate(torch.zeros((1, 4), dtype=torch.int32), 16,
                       policy="natural")


@pytest.mark.parametrize("policy", ["wide", "clip", "wrap", "sorted",
                                    "sorted_tiled", "sorted_tiled_seq"])
def test_quantized_matmul_sim_matches_jax(policy):
    r = np.random.default_rng(len(policy))
    wq = r.integers(-127, 128, (12, 96)).astype(np.int32)
    xq = r.integers(0, 128, (10, 96)).astype(np.int32)
    kw = dict(policy=policy, k_tile=32, batch_chunk=4, rounds=2)
    t = tov.quantized_matmul_sim(torch.from_numpy(wq), torch.from_numpy(xq),
                                 14, **kw)
    assert t.dtype == torch.int32
    _eq(t, jov.quantized_matmul_sim(jnp.asarray(wq), jnp.asarray(xq), 14,
                                    **kw))


@pytest.mark.parametrize("batch_chunk", [3, 128])
def test_matmul_census_matches_jax(batch_chunk):
    r = np.random.default_rng(batch_chunk)
    wq = r.integers(-127, 128, (9, 80)).astype(np.int32)
    xq = r.integers(0, 128, (11, 80)).astype(np.int32)
    for acc_bits in (12, 16):
        _census_eq(tov.matmul_census(torch.from_numpy(wq),
                                     torch.from_numpy(xq), acc_bits,
                                     batch_chunk),
                   jov.matmul_census(jnp.asarray(wq), jnp.asarray(xq),
                                     acc_bits, batch_chunk))


@pytest.mark.parametrize("k", [1, 7, 64, 255])
@pytest.mark.parametrize("max_rounds", [None, 1, 2])
def test_alg1_sorted_dot_matches_jax(k, max_rounds):
    """The exact value at full rounds; with a round cap the partial
    rounds' sum (still exact: a round preserves the sum)."""
    prods = _prods(k, (5, k))
    t = tsa.alg1_sorted_dot(torch.from_numpy(prods), max_rounds)
    assert t.dtype == torch.int32
    _eq(t, jsa.alg1_sorted_dot(jnp.asarray(prods), max_rounds))
    _eq(t, prods.sum(-1, dtype=np.int32))


def test_alg1_both_signs_predicate_is_global():
    """A batch where one dot is single-signed and another mixed: the
    single-signed dot still takes every round (JAX's jnp.any has no
    axis), and a batch of single-signed dots takes none."""
    prods = np.array([[5, 3, 0, 9], [7, -2, -6, 4]], np.int32)
    _eq(tsa.alg1_sorted_dot(torch.from_numpy(prods)),
        jsa.alg1_sorted_dot(jnp.asarray(prods)))
    same = np.abs(prods)
    _eq(tsa.alg1_sorted_dot(torch.from_numpy(same)),
        jsa.alg1_sorted_dot(jnp.asarray(same)))


def test_order_aliases_match_jax():
    prods = _prods(3, (4, 128))
    _eq(tsa.sorted_single_round_order(torch.from_numpy(prods)),
        jsa.sorted_single_round_order(jnp.asarray(prods)))
    for k_tile in (16, 32, 128):
        _eq(tsa.tiled_pairwise_order(torch.from_numpy(prods), k_tile),
            jsa.tiled_pairwise_order(jnp.asarray(prods), k_tile))


@pytest.mark.parametrize("shape", [(6, 32), (3, 4, 16)])
def test_sparsity_matches_jax(shape):
    r = np.random.default_rng(len(shape))
    w = (r.standard_normal(shape) * (r.random(shape) < 0.6)).astype(
        np.float32)
    t = tpr.sparsity(torch.from_numpy(w))
    assert t.dtype == torch.float32
    _eq(t, jpr.sparsity(jnp.asarray(w)))


@pytest.mark.parametrize("args", [(100, 10, 16, 0.3), (30, 10, 16, 0.5),
                                  (60, 7, 8, 0.25), (20, 10, 4, 0.75),
                                  (5, 10, 16, 0.3), (90, 10, 16, 0.0)])
def test_iterative_nm_schedule_matches_jax(args):
    assert tpr.iterative_nm_schedule(*args) == jpr.iterative_nm_schedule(
        *args)


@pytest.mark.parametrize("keep_frac", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape", [(12, 20), (8, 3, 5)])
def test_filter_prune_mask_matches_jax(keep_frac, shape):
    """Rows of distinct L2 norms (each row scaled by its own factor), so
    the threshold splits the same rows in both."""
    r = np.random.default_rng(int(keep_frac * 100) + len(shape))
    w = r.standard_normal(shape).astype(np.float32)
    w *= (1.0 + np.arange(shape[0], dtype=np.float32)[r.permutation(
        shape[0])]).reshape((-1,) + (1,) * (len(shape) - 1))
    norms = np.linalg.norm(w.reshape(shape[0], -1), axis=1)
    assert len(set(norms.tolist())) == shape[0]
    _eq(tpr.filter_prune_mask(torch.from_numpy(w), keep_frac),
        jpr.filter_prune_mask(jnp.asarray(w), keep_frac))


@pytest.mark.parametrize("rank", [1, 3, 8, 50])
@pytest.mark.parametrize("shape", [(16, 24), (30, 10)])
def test_low_rank_approx_matches_jax(rank, shape):
    r = np.random.default_rng(rank + shape[0])
    w = r.standard_normal(shape).astype(np.float32)
    t = tpr.low_rank_approx(torch.from_numpy(w), rank)
    assert t.shape == shape
    np.testing.assert_allclose(t.numpy(), np.asarray(jpr.low_rank_approx(
        jnp.asarray(w), rank)), rtol=1e-4, atol=1e-5)
