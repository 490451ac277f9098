"""The port's numerics oracle against the JAX package, bit-exact.

Each test draws its inputs once with numpy from a seed and feeds the same
arrays to ``repro`` (JAX, on the CPU) and ``repro_torch`` (torch, CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_shim import given, settings
from _hypothesis_shim import strategies as st

from repro.core import overflow as jov
from repro.core import pruning as jpr
from repro.core import quant as jq
from repro.core import sorted_accum as jsa
from repro.kernels import bitonic as jbit
from repro_torch.core import overflow as tov
from repro_torch.core import pruning as tpr
from repro_torch.core import quant as tq
from repro_torch.core import sorted_accum as tsa


def _prods(seed, shape, extreme=False):
    """int32 partial products of int8 draws; ``extreme`` mixes in the
    int8 corners (+-127, -128) and duplicates."""
    r = np.random.default_rng(seed)
    a = r.integers(-128, 128, shape)
    b = r.integers(-128, 128, shape)
    if extreme:
        corners = np.array([-128, -127, 127, 0, 1, -1])
        pick = r.random(shape) < 0.4
        a = np.where(pick, r.choice(corners, shape), a)
        b = np.where(r.random(shape) < 0.4, r.choice(corners, shape), b)
    return (a * b).astype(np.int32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 16, 24, 30])
def test_qrange(bits):
    assert tq.qrange(bits) == jq.qrange(bits)


@pytest.mark.parametrize("n_keep,m", [(8, 16), (2, 4), (1, 4), (4, 4)])
def test_nm_prune_mask(n_keep, m):
    r = np.random.default_rng(n_keep * 100 + m)
    w = r.standard_normal((6, 4 * m)).astype(np.float32)
    _eq(tpr.nm_prune_mask(torch.from_numpy(w), n_keep, m),
        jpr.nm_prune_mask(jnp.asarray(w), n_keep, m))


def test_nm_prune_mask_ties():
    """Tied magnitudes (and signs) keep the lower indices in both."""
    r = np.random.default_rng(7)
    w = r.choice(np.array([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32), (8, 32))
    for n_keep, m in ((8, 16), (2, 4), (3, 8)):
        _eq(tpr.nm_prune_mask(torch.from_numpy(w), n_keep, m),
            jpr.nm_prune_mask(jnp.asarray(w), n_keep, m))


@pytest.mark.parametrize("k", [1, 7, 64, 255])
def test_pairwise_round_and_sorted_order(k):
    for extreme in (False, True):
        p = _prods(k, (5, k), extreme)
        _eq(tsa.pairwise_round(torch.from_numpy(p)),
            jsa.pairwise_round(jnp.asarray(p)))
        for rounds in (1, 2):
            _eq(tsa.sorted_order(torch.from_numpy(p), rounds),
                jsa.sorted_order(jnp.asarray(p), rounds))


# int8 operand rows for test_sort_keys_fit_int16: random, or the corners
# whose products reach the ends of [-16256, 16384]
_CORNERS = (None, (-128, -128), (-128, 127), (127, 127), "mixed")


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 8),
       st.integers(0, len(_CORNERS) - 1))
def test_sort_keys_fit_int16(seed, log2_len, corner):
    """The premise of the CUDA kernels' packed int16x2 sort: for int8
    operands every product, and every key after each of 1 to 3
    split/sort/pair rounds of the port's ``pairwise_round`` /
    ``sorted_order``, lies in [-32768, 32767], and the rounds equal the
    JAX package's ``sorted_order_bitonic`` (the Pallas kernels' network)
    on the same inputs."""
    r = np.random.default_rng(seed)
    shape = (4, 1 << log2_len)
    x = r.integers(-128, 128, shape)
    w = r.integers(-128, 128, shape)
    pick = _CORNERS[corner]
    if pick == "mixed":
        x = r.choice(np.array([-128, 127]), shape)
        w = r.choice(np.array([-128, 127]), shape)
    elif pick is not None:
        x[:2], w[:2] = pick
    prods = (x * w).astype(np.int32)
    keys = torch.from_numpy(prods)
    assert -16256 <= int(keys.min()) and int(keys.max()) <= 16384
    for rounds in (1, 2, 3):
        keys = tsa.pairwise_round(keys)
        assert -32768 <= int(keys.min()) and int(keys.max()) <= 32767
        _eq(keys, tsa.sorted_order(torch.from_numpy(prods), rounds))
        _eq(keys, jbit.sorted_order_bitonic(jnp.asarray(prods), rounds))


def test_pairwise_round_sentinel_extremes():
    """Values at the int32 edges never meet a negated sentinel."""
    p = np.array([[2**31 - 1, -(2**31) + 1, 5, -5, 0, 0, 3, -2**30]],
                 np.int32)
    _eq(tsa.pairwise_round(torch.from_numpy(p)),
        jsa.pairwise_round(jnp.asarray(p)))


@pytest.mark.parametrize("k_tile,rounds", [(16, 1), (16, 2), (64, 1)])
def test_tiled_seq_order(k_tile, rounds):
    p = _prods(k_tile + rounds, (4, 3, 4 * k_tile), extreme=True)
    _eq(tsa.tiled_seq_order(torch.from_numpy(p), k_tile, rounds),
        jsa.tiled_seq_order(jnp.asarray(p), k_tile, rounds))


@pytest.mark.parametrize("n_tiles", [1, 2, 5])
def test_tiled_sorted_order(n_tiles):
    p = _prods(n_tiles, (3, 4, 16 * n_tiles), extreme=True)
    _eq(tsa.tiled_sorted_order(torch.from_numpy(p), 16, 2),
        jsa.tiled_sorted_order(jnp.asarray(p), 16, 2))


@pytest.mark.parametrize("acc_bits", [12, 16, 24])
@pytest.mark.parametrize("saturate", [True, False])
def test_monotone_accumulate(acc_bits, saturate):
    # long enough, and extreme enough, to leave a 12-bit register
    p = _prods(acc_bits, (6, 96), extreme=True) * 4
    acc, ovf = tsa.monotone_accumulate(torch.from_numpy(p), acc_bits,
                                       saturate)
    jacc, jovf = jsa.monotone_accumulate(jnp.asarray(p), acc_bits, saturate)
    _eq(acc, jacc)
    _eq(ovf, jovf)
    if acc_bits == 12:
        assert ovf.any()  # the case exercises the clip / wrap path


def test_monotone_accumulate_refuses_wide_register():
    with pytest.raises(ValueError):
        tsa.monotone_accumulate(torch.zeros((1, 4), dtype=torch.int32), 31)


@pytest.mark.parametrize("policy", ["wide", "clip", "wrap",
                                    "sorted_tiled_seq", "sorted",
                                    "sorted_tiled"])
@pytest.mark.parametrize("acc_bits", [12, 16])
def test_accumulate_policies(policy, acc_bits):
    r = np.random.default_rng(acc_bits)
    x = r.integers(-128, 128, (4, 128)).astype(np.int8)
    w = r.integers(-128, 128, (5, 128)).astype(np.int8)
    tp = tov.partial_products(torch.from_numpy(w), torch.from_numpy(x))
    jp = jov.partial_products(jnp.asarray(w), jnp.asarray(x))
    _eq(tp, jp)
    for rounds in (1, 2):
        _eq(tov.accumulate(tp, acc_bits, policy, 32, rounds),
            jov.accumulate(jp, acc_bits, policy, 32, rounds))
