"""The port's global-sort policies (``sorted``, ``sorted_tiled``) against the
JAX package, bit-exact.

On the CPU each kernel wrapper runs its plain version; each is held against
its Pallas kernel run in interpret mode with small blocks (bm=4, bn=8), as
tests/test_sorted_stream.py runs them: the one-pass ``sort_matmul``, the
two-pass ``tile_sums_matmul`` and ``paired_accum_matmul`` (fed the JAX
package's own permutation) and ``chunked_sort_matmul``. The routing
(``resolve_sort_impl``, ``pqs_dot(sort_impl=...)``) and a smoke
``ServingEngine`` under both policies are held against the JAX package
too. The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py (marker ``cuda``) and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import dispatch as jd
from repro.core.qtensor import QTensor as JQTensor
from repro.core.qtensor import quantize_tree as jquantize_tree
from repro.core.sorted_accum import pair_permutation as jpair_permutation
from repro.kernels import ops as jops
from repro.kernels import sorted_matmul as jsm
from repro.kernels import sorted_stream as jss
from repro.models.model import build_model as jbuild_model
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch as td
from repro_torch.core.sorted_accum import pair_permutation
from repro_torch.kernels import ops
from repro_torch.kernels import sorted_matmul as tsm
from repro_torch.kernels import sorted_stream as tss
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine

BLOCKS = dict(bm=4, bn=8, interpret=True)
# (K, k_tile, acc_bits, rounds): even, odd and single tile counts at
# k_tile 64 / 128 / 256, rounds 1 and 2 (each case one Pallas compile)
TILED = ((256, 64, 12, 1), (192, 64, 16, 2), (64, 64, 12, 2),
         (384, 128, 16, 1), (768, 256, 12, 2), (512, 256, 16, 1))
ATOL = 1e-4  # float logits, as tests/test_torch_serving.py states


def _xw(m, k, n, seed, k_tile=None):
    """Seeded int8 x (m, k), w (n, k): row 0 saturating, row 1 of x all
    zero (every tile sum 0), and with ``k_tile`` row 2 of x and of w one
    tile repeated (every tile sum of output (2, 2) equal)."""
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-127, 128, (n, k)).astype(np.int8)
    x[0] = 127
    w[0, : k // 2] = 127
    x[1] = 0
    if k_tile is not None:
        x[2] = np.tile(x[2, :k_tile], k // k_tile)
        w[2] = np.tile(w[2, :k_tile], k // k_tile)
    return x, w


def _pair(x, w):
    return (jnp.asarray(x), jnp.asarray(w)), (torch.from_numpy(x),
                                              torch.from_numpy(w))


@pytest.mark.parametrize("k,k_tile,acc_bits,rounds", TILED)
def test_sort_matmul_sorted_tiled_matches_pallas(k, k_tile, acc_bits,
                                                 rounds):
    (jx, jw), (tx, tw) = _pair(*_xw(8, k, 8, k + acc_bits, k_tile))
    kw = dict(policy="sorted_tiled", acc_bits=acc_bits, k_tile=k_tile,
              rounds=rounds)
    want = jsm.sort_matmul(jx, jw, **kw, **BLOCKS)
    np.testing.assert_array_equal(tsm.sort_matmul(tx, tw, **kw).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("k,acc_bits,rounds", [(1, 12, 1), (64, 16, 2),
                                                (256, 12, 2), (1024, 16, 1)])
def test_sort_matmul_sorted_matches_pallas(k, acc_bits, rounds):
    (jx, jw), (tx, tw) = _pair(*_xw(8, k, 8, k + acc_bits))
    kw = dict(policy="sorted", acc_bits=acc_bits, rounds=rounds)
    want = jsm.sort_matmul(jx, jw, **kw, **BLOCKS)
    np.testing.assert_array_equal(tsm.sort_matmul(tx, tw, **kw).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("k,k_tile,acc_bits,rounds", TILED)
def test_two_pass_kernels_match_pallas(k, k_tile, acc_bits, rounds):
    """Pass 1 exactly, the permutation of its sums exactly, and pass 2 on
    the JAX package's own permutation."""
    (jx, jw), (tx, tw) = _pair(*_xw(8, k, 16, k + k_tile, k_tile))
    jsums = jss.tile_sums_matmul(jx, jw, k_tile=k_tile, **BLOCKS)
    sums = tss.tile_sums_matmul(tx, tw, k_tile=k_tile)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    jperm = jpair_permutation(jsums)
    np.testing.assert_array_equal(pair_permutation(sums).numpy(),
                                  np.asarray(jperm))
    perm = torch.tensor(np.asarray(jperm), dtype=torch.int32)
    kw = dict(acc_bits=acc_bits, k_tile=k_tile, rounds=rounds)
    want = jss.paired_accum_matmul(jx, jw, jperm, **kw, **BLOCKS)
    got = tss.paired_accum_matmul(tx, tw, perm, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,rounds", [(64, 2), (256, 2), (1024, 1)])
def test_chunked_sort_matmul_matches_pallas(k, rounds):
    (jx, jw), (tx, tw) = _pair(*_xw(8, k, 16, k))
    want = jss.chunked_sort_matmul(jx, jw, acc_bits=14, rounds=rounds,
                                   bc=4, **BLOCKS)
    got = tss.chunked_sort_matmul(tx, tw, acc_bits=14, rounds=rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", ["sorted", "sorted_tiled"])
def test_one_pass_equals_two_pass(policy):
    k = 1024 if policy == "sorted" else 768
    _, (tx, tw) = _pair(*_xw(8, k, 16, 5, 256))
    kw = dict(policy=policy, acc_bits=14, k_tile=256, rounds=1)
    np.testing.assert_array_equal(tsm.sort_matmul(tx, tw, **kw).numpy(),
                                  tss.stream_sort_matmul(tx, tw, **kw).numpy())


@pytest.mark.parametrize("interpret", [False, True])
def test_resolve_sort_impl_matches_jax(interpret):
    for kp in (1536, 8960, 4096, 4097, 65536, 65537):
        for impl in ops.SORT_IMPLS + ("bogus",):
            try:
                want = jops.resolve_sort_impl(kp, interpret, impl)
            except ValueError:
                with pytest.raises(ValueError):
                    ops.resolve_sort_impl(kp, interpret, impl)
                continue
            assert ops.resolve_sort_impl(kp, interpret, impl) == want, (
                kp, impl)
    assert (ops.MAX_RESIDENT_K, ops.MAX_STREAM_K, ops.SORT_IMPLS) == (
        jops.MAX_RESIDENT_K, jops.MAX_STREAM_K, jops.SORT_IMPLS)


@pytest.mark.parametrize("policy", ["sorted", "sorted_tiled"])
def test_pqs_dot_and_routing_match_jax(policy):
    """K not a multiple of k_tile (300 -> 320 / 512), ragged M and N:
    every sort_impl of ops.policy_matmul (the plain kernels behind it on
    the CPU) and of pqs_dot gives JAX's pqs_dot."""
    x, w = _xw(5, 300, 9, 3, None)
    (jx, jw), (tx, tw) = _pair(x, w)
    want = np.asarray(jd.pqs_dot(jx, jw, acc_bits=14, policy=policy,
                                 k_tile=64, backend="jnp"))
    kp = ops.padded_k(300, policy, 64)
    for impl in ops.SORT_IMPLS:
        got = td.pqs_dot(tx, tw, acc_bits=14, policy=policy, k_tile=64,
                         sort_impl=impl)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)
        # policy_matmul takes K as it is (the kernels' kp) or padded
        for a, b in ((tx, tw), (ops._pad_to(tx, kp, 1),
                                ops._pad_to(tw, kp, 1))):
            direct = ops.policy_matmul(a, b, policy=policy, acc_bits=14,
                                       k_tile=64, sort_impl=impl)
            np.testing.assert_array_equal(direct.numpy(), want,
                                          err_msg=impl)


@pytest.mark.parametrize("kernel", ["sort_matmul[sorted]",
                                    "sort_matmul[sorted_tiled]",
                                    "tile_sums_matmul", "paired_accum_matmul",
                                    "chunked_sort_matmul"])
def test_kp_extends_rows_with_zero_products(kernel):
    """Each wrapper's ``kp`` (the policy's padded K) on K = 300 gives what
    the wrapper gives on operands zero-padded to kp, and refuses a kp
    below K or off the policy's rule."""
    x, w = _xw(5, 300, 9, 8, None)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    policy = "sorted" if kernel in ("sort_matmul[sorted]",
                                    "chunked_sort_matmul") else "sorted_tiled"
    kp = ops.padded_k(300, policy, 64)
    px, pw = ops._pad_to(tx, kp, 1), ops._pad_to(tw, kp, 1)
    perm = pair_permutation(tss.tile_sums_matmul(px, pw, k_tile=64)).to(
        torch.int32)
    calls = {
        "sort_matmul[sorted]": lambda a, b, **k: tsm.sort_matmul(
            a, b, policy="sorted", acc_bits=13, rounds=2, **k),
        "sort_matmul[sorted_tiled]": lambda a, b, **k: tsm.sort_matmul(
            a, b, policy="sorted_tiled", acc_bits=13, k_tile=64, **k),
        "tile_sums_matmul": lambda a, b, **k: tss.tile_sums_matmul(
            a, b, k_tile=64, **k),
        "paired_accum_matmul": lambda a, b, **k: tss.paired_accum_matmul(
            a, b, perm, acc_bits=13, k_tile=64, **k),
        "chunked_sort_matmul": lambda a, b, **k: tss.chunked_sort_matmul(
            a, b, acc_bits=13, **k),
    }
    call = calls[kernel]
    np.testing.assert_array_equal(call(tx, tw, kp=kp).numpy(),
                                  call(px, pw).numpy())
    for bad in (256, kp + 1):
        with pytest.raises(ValueError):
            call(tx, tw, kp=bad)


def test_two_pass_refuses_wide_carriers():
    x = torch.full((2, 64), 300, dtype=torch.int32)
    w = torch.ones((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 values"):
        ops.policy_matmul(x, w, policy="sorted_tiled", acc_bits=16,
                          k_tile=64, sort_impl="twopass")
    # the one-pass plain version takes the wider carrier, as JAX's does
    ops.policy_matmul(x, w, policy="sorted_tiled", acc_bits=16, k_tile=64,
                      sort_impl="onepass")


def test_sort_stats_chunking_is_exact():
    """The two-pass statistic budget chunks M; chunking is exact."""
    x, w = _xw(9, 256, 8, 4, 64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    whole = td.pqs_dot(tx, tw, policy="sorted_tiled", k_tile=64)
    for chunk in (1, 4):
        np.testing.assert_array_equal(
            td.pqs_dot(tx, tw, policy="sorted_tiled", k_tile=64,
                       batch_chunk=chunk).numpy(), whole.numpy())
    assert td._SORT_STATS_BUDGET == jd._SORT_STATS_BUDGET


def _to_numpy(tree):
    if isinstance(tree, JQTensor):
        return {"values": np.array(tree.values), "scale": np.array(tree.scale)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    qparams = jquantize_tree(jmodel.init(jax.random.PRNGKey(0)), bits=8,
                             n_keep=8, m=16, min_size=1 << 12, min_dim=16)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(_to_numpy(qparams), device="cpu")
    return jmodel, qparams, tmodel, tparams


@pytest.mark.parametrize("policy", ["sorted_tiled", "sorted"])
def test_engine_global_sort_matches_jax(models, policy):
    """Greedy tokens of both engines, and prefill / decode logits within
    ATOL, under a global-sort policy at a 12-bit register (k_tile 16:
    several tiles a site, so the pairing is exercised)."""
    jmodel, qparams, tmodel, tparams = models
    jcfg = jd.IntegerLinConfig(policy=policy, acc_bits=12, k_tile=16,
                               backend="jnp")
    tcfg = td.IntegerLinConfig(policy=policy, acc_bits=12, k_tile=16)
    r = np.random.default_rng(6)
    # one admission cohort, one prefill bucket: few JAX compiles
    prompts = [r.integers(0, 256, size=int(r.integers(5, 9))).astype(
        np.int32) for _ in range(3)]
    jeng = JServingEngine(jmodel, qparams, num_slots=3, max_len=32,
                          int_lin=jcfg)
    teng = ServingEngine(tmodel, tparams, num_slots=3, max_len=32,
                         device="cpu", int_lin=tcfg)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.drain(jreqs)
    teng.drain(treqs)
    assert [q.output for q in treqs] == [q.output for q in jreqs]

    toks = r.integers(0, 256, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 0], np.int32)
    nxt = r.integers(0, 256, (3, 1)).astype(np.int32)
    with jd.integer_lin(jcfg):
        caches = jmodel.init_caches(qparams, 3, 32, jnp.float32)
        jp, caches = jmodel.prefill(qparams, jnp.asarray(toks), caches,
                                    jnp.asarray(lengths))
        jdec, _ = jmodel.decode(qparams, jnp.asarray(nxt), caches)
    with td.integer_lin(tcfg):
        caches = tmodel.init_caches(tparams, 3, 32, torch.float32)
        tp, caches = tmodel.prefill(tparams, torch.from_numpy(toks), caches,
                                    torch.from_numpy(lengths))
        tdec, _ = tmodel.decode(tparams, torch.from_numpy(nxt), caches)
    for j, t in ((jp, tp), (jdec, tdec)):
        assert np.isfinite(t.numpy()).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
