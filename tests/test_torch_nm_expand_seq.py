"""Row 5, the K-streaming policies on N:M slabs with each row expanded
(``nm_seq_policy_matmul``), and row 4, the wide ``nm_spmm``, on slabs whose
slots name one position twice with a sum past int8, held against the JAX
package's Pallas kernels in interpret mode; and the routes that send a
compressed matmul to row 5 (``wide``, ``certified``).

The expanded weight at such a position is the int32 sum of its slots (the
JAX one-hot expansion), so its products leave int8 x int8 and may leave
int16. The card kernels keep that on their int32 routes (the expand
kernel's window flag, the tensor-core kernel's exact sums,
``csrc/nm_expand_seq.cu`` and ``csrc/nm_chunks.cuh``); their plain
versions, held here, are what tests/test_torch_cuda.py (marker ``cuda``)
holds the card kernels against.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core import dispatch as jd
from repro.kernels import nm_spmm as jnm
from repro.kernels import ops as jops
from repro_torch.core import dispatch as td
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import ops
from test_torch_nm_sort import _case, _t

BLOCKS = dict(bm=8, bn=8, interpret=True)


def _jax_operands(x, vals, idx):
    """x's rows and the slabs' rows zero-padded to multiples of 8 (the
    JAX kernels' blocks of 8 x 8)."""
    rows = ((0, -x.shape[0] % 8), (0, 0))
    slabs = ((0, -vals.shape[0] % 8), (0, 0), (0, 0))
    return (jnp.asarray(np.pad(x, rows)), jnp.asarray(np.pad(vals, slabs)),
            jnp.asarray(np.pad(idx, slabs)))


def _smallest():
    """M = 2, K = 16, one 2:16 group whose two slots both name position 0
    with value 127, x[:, 0] = (1, 127): the expanded weight 254 (past int8),
    the products 254 and 32258."""
    x = np.zeros((2, 16), np.int8)
    x[:, 0] = (1, 127)
    vals = np.full((1, 1, 2), 127, np.int8)
    idx = np.zeros((1, 1, 2), np.int32)
    return x, vals, idx


def _stacked(seed):
    """M = 5, N = 9, K = 256 at 8:16 (16 groups, one k_tile of 256), x's
    odd positions -128: in every third group slots 0 and 1 at slot 0's
    position with value 127 (a weight of 254), in every fifth with -128
    (-256, whose product with -128 is 32768, past int16)."""
    x, _, vals, idx = _case(5, 9, 256, 8, 16, seed)
    x, vals, idx = x.copy(), vals.copy(), idx.copy()
    x[:, 1::2] = -128
    idx[:, ::3, 1] = idx[:, ::3, 0]
    vals[:, ::3, :2] = 127
    idx[:, ::5, 1] = idx[:, ::5, 0] | 1
    idx[:, ::5, 0] = idx[:, ::5, 1]
    vals[:, ::5, :2] = -128
    return x, vals, idx


# (policy, acc_bits, rounds): every SEQ policy; sorted_tiled_seq with no
# round and with three; each case one Pallas compile
SEQ_RUNS = (("wide", 16, 1), ("clip", 12, 1), ("wrap", 12, 1),
            ("sorted_tiled_seq", 12, 0), ("sorted_tiled_seq", 12, 3))


@pytest.mark.parametrize("run", SEQ_RUNS, ids=str)
def test_expand_seq_smallest_duplicate_case(run):
    """The smallest case under each policy: the plain version equals the
    JAX kernel (whose one-hot expansion adds the slots in int32); the
    register of row 1 is 32258, or its 12-bit clip or wrap."""
    policy, acc_bits, rounds = run
    x, vals, idx = _smallest()
    kw = dict(m_group=16, policy=policy, acc_bits=acc_bits, rounds=rounds)
    got = nm_spmm.nm_seq_policy_matmul(*_t(x, vals, idx), **kw, k_tile=16)
    want = np.asarray(jnm.nm_seq_policy_matmul(
        *_jax_operands(x, vals, idx), **kw, bg=1, **BLOCKS))[:2, :1]
    np.testing.assert_array_equal(got.numpy(), want)
    expect = {"wide": 32258, "clip": 2047, "wrap": 32258 % 4096 - 4096 * (
        32258 % 4096 >= 2048)}.get(policy, 2047)
    assert got.flatten().tolist() == [254, expect]


@pytest.mark.parametrize("run", SEQ_RUNS, ids=str)
def test_expand_seq_duplicates_past_int8(run):
    """Slabs whose slots name one position twice, their weights 254 and
    -256 and products past int16, under each policy at k_tile 256: the
    plain version equals the JAX kernel."""
    policy, acc_bits, rounds = run
    x, vals, idx = _stacked(11)
    kw = dict(m_group=16, policy=policy, acc_bits=acc_bits, rounds=rounds)
    got = nm_spmm.nm_seq_policy_matmul(*_t(x, vals, idx), **kw, k_tile=256)
    want = np.asarray(jnm.nm_seq_policy_matmul(
        *_jax_operands(x, vals, idx), **kw, bg=16, **BLOCKS))[:5, :9]
    np.testing.assert_array_equal(got.numpy(), want)
    w = nm_spmm.expand_nm_slab(*_t(vals, idx), 16)
    assert int(w.max()) == 254 and int(w.min()) == -256


def test_nm_spmm_duplicates_past_int8():
    """Row 4's plain version on the same slabs and on the smallest case
    equals the JAX ``nm_spmm``: the int32 sum, (254, 32258) where a byte
    of the tile would give (-2, -254)."""
    for x, vals, idx, m, n in ((*_smallest(), 2, 1), (*_stacked(12), 5, 9)):
        got = nm_spmm.nm_spmm_ref(*_t(x, vals, idx), m_group=16)
        want = np.asarray(jnm.nm_spmm(*_jax_operands(x, vals, idx),
                                      m_group=16, bg=1, **BLOCKS))[:m, :n]
        assert got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)
    x, vals, idx = _smallest()
    assert nm_spmm.nm_spmm_ref(*_t(x, vals, idx)).flatten().tolist() == [
        254, 32258]


@pytest.mark.parametrize("g", [4, 8, 19])
def test_resolve_nm_impl_wide_takes_expand(g):
    """``wide`` on compressed slabs takes the expand kernel (row 5) under
    ``auto`` whatever G is, as the JAX rule does; the other K-streaming
    policies take the gather from ``GATHER_MIN_G`` groups on."""
    for policy in ("wide", "clip", "wrap", "sorted_tiled_seq"):
        want = jops.resolve_nm_impl(policy, g, 8, 16, "auto")
        assert ops.resolve_nm_impl(policy, g, 8, 16) == want
        assert ops.resolve_nm_impl(policy, g, 8, 16, "auto") == want
    assert ops.resolve_nm_impl("wide", g, 8, 16) == "expand"
    assert ops.resolve_nm_impl("sorted_tiled_seq", g, 8, 16) == (
        "gather" if g >= ops.GATHER_MIN_G else "expand")


def test_certified_compressed_dot_takes_expand_and_matches_jax(monkeypatch):
    """``pqs_dot(certified=True)`` on compressed slabs: the kernels' path
    (``_local_dot(backend="cuda")``, which CPU tensors run through the plain
    versions) sends every policy to row 5 under ``wide``, even with 19
    groups where ``auto`` takes the gather for the policy itself; the
    result equals the JAX ``pqs_dot(certified=True)`` and the plain
    backend's, on canonical slabs and on slabs past int8."""
    calls = []
    for name in ("nm_seq_policy_matmul", "nm_gather_seq_policy_matmul"):
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, kw["policy"]))
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    x, _, vals, idx = _case(5, 9, 300, 8, 16, 13)
    sx, sv, si = _stacked(14)
    for xs, vs, ids in ((x, vals, idx), (sx, sv, si)):
        kw = dict(acc_bits=12, policy="sorted_tiled_seq", k_tile=256)
        xs = np.pad(xs, ((0, 0), (0, vs.shape[1] * 16 - xs.shape[1])))
        want = np.asarray(jd.pqs_dot(
            jnp.asarray(xs), (jnp.asarray(vs), jnp.asarray(ids)),
            storage="nm", m_group=16, certified=True, backend="pallas",
            **kw))
        tx, tv, ti = _t(xs, vs, ids)
        calls.clear()
        got = td._local_dot(tx, (tv, ti), rounds=1, backend="cuda",
                            batch_chunk=None, m_group=16, certified=True,
                            **kw)
        assert calls == [("nm_seq_policy_matmul", "wide")], calls
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(td.pqs_dot(
            tx, (tv, ti), storage="nm", m_group=16, certified=True,
            **kw).numpy(), want)
