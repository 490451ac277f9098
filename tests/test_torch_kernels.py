"""The port's kernel layer against the JAX package, bit-exact.

On the CPU, ``seq_policy_matmul`` runs its plain version; it is held
against the Pallas kernel in interpret mode (as tests/test_kernels.py
runs it), and ``policy_matmul`` / ``pqs_dot`` against the JAX
``pqs_dot(backend="jnp")`` on ragged shapes. The CUDA kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py
(marker ``cuda``) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dispatch import pqs_dot as jpqs_dot
from repro.kernels import sorted_matmul as jsm
from repro_torch.core.dispatch import pqs_dot
from repro_torch.kernels import ops
from repro_torch.kernels import sorted_matmul as tsm

POLICIES = ("wide", "clip", "wrap", "sorted", "sorted_tiled",
            "sorted_tiled_seq")
SHAPES = ((5, 300, 70), (8, 64, 16), (3, 100, 9))  # (M, K, N)


def _xw(m, k, n, seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-127, 128, (n, k)).astype(np.int8)
    # near-extreme rows so a 12/16-bit register saturates
    x[0] = 127
    w[0, : k // 2] = 127
    return x, w


@pytest.mark.parametrize("policy", tsm.SEQ_POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16])
@pytest.mark.parametrize("rounds", [1, 2])
def test_seq_policy_matmul_ref_matches_pallas(policy, acc_bits, rounds):
    x, w = _xw(8, 128, 16, seed=acc_bits + rounds)
    bk = 32 if policy == "sorted_tiled_seq" else 64
    want = jsm.seq_policy_matmul(
        jnp.asarray(x), jnp.asarray(w), policy=policy, acc_bits=acc_bits,
        rounds=rounds, bm=8, bn=16, bk=bk, interpret=True)
    got = tsm.seq_policy_matmul(
        torch.from_numpy(x), torch.from_numpy(w), policy=policy,
        acc_bits=acc_bits, rounds=rounds, k_tile=bk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16])
def test_pqs_dot_ragged_matches_jax(policy, acc_bits):
    for m, k, n in SHAPES:
        x, w = _xw(m, k, n, seed=acc_bits * 31 + m)
        want = np.asarray(jpqs_dot(jnp.asarray(x), jnp.asarray(w),
                                   acc_bits=acc_bits, policy=policy,
                                   k_tile=64, backend="jnp"))
        tx, tw = torch.from_numpy(x), torch.from_numpy(w)
        got = pqs_dot(tx, tw, acc_bits=acc_bits, policy=policy, k_tile=64)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{policy} {(m, k, n)}")
        kp = ops.padded_k(k, policy, 64)
        direct = ops.policy_matmul(ops._pad_to(tx, kp, 1),
                                   ops._pad_to(tw, kp, 1), policy=policy,
                                   acc_bits=acc_bits, k_tile=64)
        np.testing.assert_array_equal(direct.numpy(), want)


def test_pqs_dot_batched_rounds_and_chunks():
    """Leading batch dims, two rounds and M chunking agree with JAX."""
    r = np.random.default_rng(3)
    x = r.integers(-128, 128, (2, 3, 96)).astype(np.int8)
    w = r.integers(-127, 128, (7, 96)).astype(np.int8)
    for policy in ("sorted_tiled_seq", "clip"):
        want = np.asarray(jpqs_dot(jnp.asarray(x), jnp.asarray(w),
                                   acc_bits=14, policy=policy, k_tile=32,
                                   rounds=2, backend="jnp"))
        got = pqs_dot(torch.from_numpy(x), torch.from_numpy(w), acc_bits=14,
                      policy=policy, k_tile=32, rounds=2, batch_chunk=2)
        assert got.shape == (2, 3, 7)
        np.testing.assert_array_equal(got.numpy(), want)


def test_certified_is_wide():
    x, w = _xw(4, 70, 5, seed=9)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_array_equal(
        pqs_dot(tx, tw, acc_bits=12, policy="sorted_tiled_seq",
                certified=True, k_tile=32).numpy(),
        pqs_dot(tx, tw, acc_bits=12, policy="wide").numpy())


def test_padding_helpers():
    assert ops.next_pow2(1) == 1 and ops.next_pow2(4097) == 8192
    assert ops.padded_k(300, "sorted", 256) == 512
    assert ops.padded_k(300, "sorted_tiled_seq", 64) == 320
    assert ops.padded_k(300, "clip", 64) == 300
    t = torch.ones((3, 5), dtype=torch.int8)
    assert ops._pad_to(t, 4, 0).shape == (4, 5)
    assert ops._pad_to(t, 8, 1).shape == (3, 8)
    assert int(ops._pad_to(t, 8, 1)[:, 5:].abs().sum()) == 0


def test_unported_options_raise():
    x = torch.zeros((2, 8), dtype=torch.int8)
    w = torch.zeros((3, 8), dtype=torch.int8)
    for kw in ({"k_shards": 2}, {"mesh": object()}):
        with pytest.raises(NotImplementedError):
            pqs_dot(x, w, **kw)
