"""The global-sort policies (``sorted``, ``sorted_tiled``) on N:M compressed
storage in the port, against the JAX package, bit-exact.

On the CPU each gather kernel wrapper runs its plain version, which forms
the kept products only (as the JAX gather kernels do). Each is held
against its Pallas kernel run in interpret mode (blocks of 8 x 8): the
one-pass ``nm_gather_sort_matmul`` under both policies, the
two-pass ``nm_gather_tile_sums`` and ``nm_gather_paired_accum_matmul``
(fed the JAX package's own permutation) and
``nm_gather_chunked_sort_matmul``; and against the dense plain versions on
the decompressed weight, which is the zero-product prefix property that
makes gathering exact. Inputs are seeded with numpy, with a saturating row,
an all-zero row (every tile sum 0) and a row whose tiles repeat (equal
tile sums), over 2:4, 4:16, 8:16 and a ragged 3:16. The routing
(``nm_policy_matmul``'s ``sort_impl``, ``pqs_dot(storage="nm")``) and a
smoke ``ServingEngine`` on compressed weights are held against the JAX
package too. The CUDA kernels are held against these plain versions on the
card by tests/test_torch_cuda.py (marker ``cuda``) and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core import dispatch as jd
from repro.core import pruning as jpr
from repro.core import qtensor as jqt
from repro.core.sorted_accum import pair_permutation as jpair_permutation
from repro.kernels import nm_spmm as jnm
from repro.kernels import sorted_stream as jss
from repro_torch.core import dispatch as td
from repro_torch.core.sorted_accum import pair_permutation
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import ops
from repro_torch.kernels import sorted_matmul as tsm
from repro_torch.kernels import sorted_stream as tss

BLOCKS = dict(bm=8, bn=8, interpret=True)
ATOL = 1e-4  # float logits, as tests/test_torch_serving.py states


def _case(m, n, k, n_keep, m_group, seed, k_tile=None):
    """Seeded x (m, k) int8 and an (n, k) int8 weight pruned n_keep:m_group
    by the JAX mask, with its slabs: row 0 saturating, row 1 of x all zero,
    and with ``k_tile`` (dividing k) row 2 of x and of the weight one tile
    repeated (equal tile sums). Returns x, dense w, values, indices."""
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    w = r.integers(-127, 128, (n, k))
    x[0] = 127
    w[0, : k // 2] = 127
    x[1] = 0
    if k_tile is not None:
        x[2] = np.tile(x[2, :k_tile], k // k_tile)
        w[2] = np.tile(w[2, :k_tile], k // k_tile)
    kp = k + (-k) % m_group
    wd = np.pad(w, ((0, 0), (0, kp - k)))
    mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(wd, jnp.float32), n_keep,
                                        m_group))
    wd = (wd * mask).astype(np.int8)[:, :k]
    vals, idx = jpr.nm_compress(wd, n_keep, m_group)
    return x, wd, vals, idx


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_slabs(x, vals, idx, m_group, kp, pad_groups):
    """The JAX kernels' operands: x zero-padded to kp columns and, for the
    tiled kernels, the slabs zero-padded to kp / m_group groups."""
    jx = jnp.asarray(np.pad(x, ((0, 0), (0, kp - x.shape[1]))))
    g = vals.shape[1]
    gp = kp // m_group - g if pad_groups else 0
    pad = ((0, 0), (0, gp), (0, 0))
    return jx, jnp.asarray(np.pad(vals, pad)), jnp.asarray(np.pad(idx, pad))


# (n_keep, m, K, k_tile, acc_bits, rounds): 8:16 and 4:16 with whole tiles
# (odd and even tile counts), 2:4, and a ragged 3:16 (K = 300: G = 19
# groups, a tail tile of groups past G); each case one Pallas compile
TILED = ((8, 16, 768, 256, 16, 1), (4, 16, 512, 128, 12, 2),
         (2, 4, 192, 64, 12, 1), (3, 16, 300, 64, 16, 2))
SORTED = ((8, 16, 1024, 1, 16, 1), (4, 16, 256, 1, 12, 2),
          (2, 4, 192, 1, 16, 2), (3, 16, 300, 1, 12, 1))


def _tied_tile(k, k_tile):
    return k_tile if k_tile > 1 and k % k_tile == 0 else None


@pytest.mark.parametrize("case", TILED, ids=str)
def test_gather_sort_matmul_sorted_tiled_matches_pallas(case):
    n_keep, m, k, k_tile, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 8, k, n_keep, m, k + n_keep,
                            _tied_tile(k, k_tile))
    kp = ops.padded_k(vals.shape[1] * m, "sorted_tiled", k_tile)
    kw = dict(policy="sorted_tiled", acc_bits=acc_bits, k_tile=k_tile,
              rounds=rounds)
    want = jnm.nm_gather_sort_matmul(
        *_jax_slabs(x, vals, idx, m, kp, True), m_group=m, **kw, **BLOCKS)
    got = nm_spmm.nm_gather_sort_matmul(*_t(x, vals, idx), m_group=m, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", SORTED, ids=str)
def test_gather_sort_matmul_sorted_matches_pallas(case):
    n_keep, m, k, _, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 8, k, n_keep, m, k + m)
    kp = ops.padded_k(vals.shape[1] * m, "sorted", 1)
    kw = dict(policy="sorted", acc_bits=acc_bits, rounds=rounds)
    want = jnm.nm_gather_sort_matmul(
        *_jax_slabs(x, vals, idx, m, kp, False), m_group=m, **kw, **BLOCKS)
    got = nm_spmm.nm_gather_sort_matmul(*_t(x, vals, idx), m_group=m, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", TILED, ids=str)
def test_gather_two_pass_kernels_match_pallas(case):
    """Pass 1 exactly, the permutation of its sums exactly, and pass 2 on
    the JAX package's own permutation."""
    n_keep, m, k, k_tile, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 16, k, n_keep, m, k + k_tile,
                            _tied_tile(k, k_tile))
    kp = ops.padded_k(vals.shape[1] * m, "sorted_tiled", k_tile)
    jx, jv, ji = _jax_slabs(x, vals, idx, m, kp, True)
    tx, tv, ti = _t(x, vals, idx)
    jsums = jss.nm_gather_tile_sums(jx, jv, ji, m_group=m, k_tile=k_tile,
                                    **BLOCKS)
    sums = tss.nm_gather_tile_sums(tx, tv, ti, m_group=m, k_tile=k_tile)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    jperm = jpair_permutation(jsums)
    np.testing.assert_array_equal(pair_permutation(sums).numpy(),
                                  np.asarray(jperm))
    perm = torch.tensor(np.asarray(jperm), dtype=torch.int32)
    kw = dict(acc_bits=acc_bits, k_tile=k_tile, rounds=rounds, m_group=m)
    want = jss.nm_gather_paired_accum_matmul(jx, jv, ji, jperm, **kw,
                                             **BLOCKS)
    got = tss.nm_gather_paired_accum_matmul(tx, tv, ti, perm, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", SORTED[::3], ids=str)
def test_gather_chunked_sort_matmul_matches_pallas(case):
    n_keep, m, k, _, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 16, k, n_keep, m, k + 7)
    kp = ops.padded_k(vals.shape[1] * m, "sorted", 1)
    kw = dict(acc_bits=acc_bits, rounds=rounds, m_group=m)
    want = jss.nm_gather_chunked_sort_matmul(
        *_jax_slabs(x, vals, idx, m, kp, False), bc=4, **kw, **BLOCKS)
    got = tss.nm_gather_chunked_sort_matmul(*_t(x, vals, idx), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_keep,m", [(2, 4), (4, 16), (8, 16), (3, 16)])
def test_plain_versions_equal_dense_plain(n_keep, m):
    """Every gather plain version equals the dense plain version on the
    decompressed weight over the same kp (the zero-product prefix
    property), ragged K and tied tile sums included, at acc_bits 12 and
    16, rounds 1 and 2; one-pass equals two-pass."""
    for k, k_tile in ((256, 64), (300, 64), (1024, 256)):
        x, wd, vals, idx = _case(5, 9, k, n_keep, m, k + m,
                                 _tied_tile(k, k_tile))
        tx, tw, tv, ti = _t(x, wd, vals, idx)
        g = vals.shape[1]
        kt = ops.padded_k(g * m, "sorted_tiled", k_tile)
        ks = ops.padded_k(g * m, "sorted", k_tile)
        sums = tss.nm_gather_tile_sums(tx, tv, ti, m_group=m, k_tile=k_tile)
        np.testing.assert_array_equal(
            sums.numpy(), tss.tile_sums_matmul(tx, tw, k_tile=k_tile,
                                               kp=kt).numpy())
        perm = pair_permutation(sums).to(torch.int32)
        for acc_bits in (12, 16):
            for rounds in (1, 2):
                kw = dict(acc_bits=acc_bits, rounds=rounds)
                tk = dict(kw, k_tile=k_tile)
                dense = tsm.sort_matmul(tx, tw, policy="sorted_tiled", kp=kt,
                                        **tk).numpy()
                for got in (
                        nm_spmm.nm_gather_sort_matmul(
                            tx, tv, ti, m_group=m, policy="sorted_tiled",
                            **tk),
                        tss.nm_gather_paired_accum_matmul(
                            tx, tv, ti, perm, m_group=m, **tk),
                        tss.nm_gather_stream_sort_matmul(
                            tx, tv, ti, m_group=m, policy="sorted_tiled",
                            **tk)):
                    np.testing.assert_array_equal(got.numpy(), dense,
                                                  err_msg=f"{k} {kw}")
                dense = tsm.sort_matmul(tx, tw, policy="sorted", kp=ks,
                                        **kw).numpy()
                for got in (
                        nm_spmm.nm_gather_sort_matmul(
                            tx, tv, ti, m_group=m, policy="sorted", **kw),
                        tss.nm_gather_chunked_sort_matmul(
                            tx, tv, ti, m_group=m, **kw)):
                    np.testing.assert_array_equal(got.numpy(), dense,
                                                  err_msg=f"{k} {kw}")


@pytest.mark.parametrize("kernel", ["sort_matmul[sorted]",
                                    "sort_matmul[sorted_tiled]",
                                    "tile_sums", "paired_accum",
                                    "chunked_sort_matmul"])
def test_kp_extends_with_zero_groups(kernel):
    """Each gather wrapper given x of K = 300 and 3:16 slabs (G = 19, 304
    columns) accumulates over the policy's padded K (320 under
    sorted_tiled at k_tile 64, 512 under sorted), the groups past G being
    zero products: it equals the wrapper on x and slabs zero-padded to
    that kp. An x wider than kp raises."""
    m = 16
    x, _, vals, idx = _case(5, 9, 300, 3, m, 11)
    tx, tv, ti = _t(x, vals, idx)
    policy = "sorted" if kernel in ("sort_matmul[sorted]",
                                    "chunked_sort_matmul") else "sorted_tiled"
    kp = ops.padded_k(19 * m, policy, 64)
    assert kp > 19 * m
    pad = (0, 0, 0, kp // m - 19)
    px = ops._pad_to(tx, kp, 1)
    pv, pi = (torch.nn.functional.pad(a, pad) for a in (tv, ti))
    perm = pair_permutation(tss.nm_gather_tile_sums(
        px, pv, pi, m_group=m, k_tile=64)).to(torch.int32)
    calls = {
        "sort_matmul[sorted]": lambda a, v, i: (
            nm_spmm.nm_gather_sort_matmul(a, v, i, m_group=m, acc_bits=13,
                                          rounds=2)),
        "sort_matmul[sorted_tiled]": lambda a, v, i: (
            nm_spmm.nm_gather_sort_matmul(a, v, i, m_group=m, acc_bits=13,
                                          policy="sorted_tiled", k_tile=64)),
        "tile_sums": lambda a, v, i: tss.nm_gather_tile_sums(
            a, v, i, m_group=m, k_tile=64),
        "paired_accum": lambda a, v, i: (
            tss.nm_gather_paired_accum_matmul(a, v, i, perm, m_group=m,
                                              acc_bits=13, k_tile=64)),
        "chunked_sort_matmul": lambda a, v, i: (
            tss.nm_gather_chunked_sort_matmul(a, v, i, m_group=m,
                                              acc_bits=13)),
    }
    call = calls[kernel]
    np.testing.assert_array_equal(call(tx, tv, ti).numpy(),
                                  call(px, pv, pi).numpy())
    with pytest.raises(ValueError):
        call(ops._pad_to(tx, kp + 1, 1), tv, ti)


def test_pqs_dot_nm_above_resident_k_matches_jax():
    """K = 4500 (3 x 9 x 4500 at 8:16): padded K above MAX_RESIDENT_K
    under both policies, so auto takes the two-pass gather route; every
    sort_impl of nm_policy_matmul gives JAX's pqs_dot(storage="nm"):
    through its two-pass gather kernels in interpret mode for
    ``sorted_tiled``, on the decompressed weight (``jnp``) for
    ``sorted``, whose chunked kernel the tests above hold."""
    m = 16
    x, wd, vals, idx = _case(3, 9, 4500, 8, m, 21)
    xg = np.pad(x, ((0, 0), (0, vals.shape[1] * m - 4500)))
    tx, tv, ti = _t(xg, vals, idx)
    for policy, backend in (("sorted_tiled", "pallas"), ("sorted", "jnp")):
        kw = dict(acc_bits=16, policy=policy, k_tile=256)
        assert ops.padded_k(4512, policy, 256) > ops.MAX_RESIDENT_K
        want = np.asarray(jd.pqs_dot(
            jnp.asarray(xg), (jnp.asarray(vals), jnp.asarray(idx)),
            storage="nm", m_group=m, backend=backend, **kw))
        for impl in ops.SORT_IMPLS:
            got = ops.nm_policy_matmul(tx, tv, ti, m_group=m, sort_impl=impl,
                                       **kw)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{policy} {impl}")


@pytest.mark.parametrize("policy", ["sorted", "sorted_tiled"])
def test_pqs_dot_nm_matches_jax(policy):
    """K ragged (300 under 4:16: G = 19), ragged M and N: JAX's
    pqs_dot(storage="nm", backend="pallas") equals the port's pqs_dot on a
    SparseQTensor and on a bare pair for every sort_impl, and
    nm_policy_matmul (the gather plain versions) for every sort_impl."""
    from repro_torch.core.qtensor import SparseQTensor

    m = 16
    x, wd, vals, idx = _case(5, 9, 300, 4, m, 5)
    kw = dict(acc_bits=14, policy=policy, k_tile=64)
    want = np.asarray(jd.pqs_dot(
        jnp.asarray(x), jqt.SparseQTensor(jnp.asarray(vals),
                                          jnp.asarray(idx),
                                          jnp.ones(9, jnp.float32), m, 300),
        storage="nm", backend="pallas", **kw))
    np.testing.assert_array_equal(want, np.asarray(jd.pqs_dot(
        jnp.asarray(x), jnp.asarray(wd), backend="jnp", **kw)))
    tx, tv, ti = _t(x, vals, idx)
    sq = SparseQTensor(tv, ti, torch.ones(9), m, 300)
    xg = ops._pad_to(tx, 19 * m, 1)
    for impl in ops.SORT_IMPLS:
        for got in (td.pqs_dot(tx, sq, storage="nm", sort_impl=impl, **kw),
                    td.pqs_dot(xg, (tv, ti), storage="nm", m_group=m,
                               sort_impl=impl, **kw),
                    ops.nm_policy_matmul(tx, tv, ti, m_group=m,
                                         sort_impl=impl, **kw),
                    ops.nm_policy_matmul(xg, tv, ti, m_group=m,
                                         sort_impl=impl, nm_impl="expand",
                                         **kw)):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)


@pytest.mark.parametrize("policy", ["sorted", "sorted_tiled"])
def test_sort_impl_reaches_compressed_entry(monkeypatch, policy):
    """dispatch passes pqs_dot's sort_impl on to nm_policy_matmul for
    compressed storage: through the CUDA backend's path (``_local_dot``
    with backend "cuda", which the CPU tensors run through the plain
    versions) ``onepass`` reaches the one-pass gather entry and ``twopass``
    the two-pass one, with equal results."""
    m = 16
    x, _, vals, idx = _case(4, 6, 512, 8, m, 3, 256)
    tx, tv, ti = _t(x, vals, idx)
    calls = []
    for name in ("nm_gather_sort_matmul", "nm_gather_stream_sort_matmul"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    outs = {}
    for impl, entry in (("onepass", "nm_gather_sort_matmul"),
                        ("twopass", "nm_gather_stream_sort_matmul")):
        calls.clear()
        outs[impl] = td._local_dot(
            tx, (tv, ti), acc_bits=16, policy=policy, k_tile=256, rounds=1,
            backend="cuda", batch_chunk=None, m_group=m, sort_impl=impl)
        assert calls == [entry], (impl, calls)
    assert torch.equal(outs["onepass"], outs["twopass"])
    assert torch.equal(outs["onepass"], td.pqs_dot(
        tx, (tv, ti), storage="nm", m_group=m, policy=policy, k_tile=256))


def _to_numpy(tree):
    if isinstance(tree, jqt.SparseQTensor):
        return {"values": np.array(tree.values),
                "indices": np.array(tree.indices),
                "scale": np.array(tree.scale), "m_group": tree.m_group,
                "k_dim": tree.k_dim}
    if isinstance(tree, jqt.QTensor):
        return {"values": np.array(tree.values), "scale": np.array(tree.scale)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def models():
    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild_model
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import build_model

    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    # jitted: eager quantization takes seconds; both engines serve these
    # compressed params, whatever rounding XLA's fusion gave them
    qparams = jax.jit(lambda p: jqt.quantize_tree(
        p, bits=8, n_keep=8, m=16, min_size=1 << 12, min_dim=16))(
            jmodel.init(jax.random.PRNGKey(0)))
    sparams = jqt.nm_compress_tree(qparams, 8, 16)
    tmodel = build_model(dataclasses.replace(
        get_config("qwen2-1.5b", smoke=True), compute_dtype="float32"),
        device="cpu")
    return jmodel, sparams, tmodel, params_from_numpy(_to_numpy(sparams),
                                                      device="cpu")


@pytest.mark.parametrize("policy", ["sorted_tiled", "sorted"])
def test_engine_compressed_global_sort_matches_jax(models, policy):
    """Greedy tokens of both engines on compressed weights, and prefill /
    decode logits within ATOL, under a global-sort policy at a 12-bit
    register (k_tile 16: several tiles a site, so the pairing runs)."""
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.core.qtensor import SparseQTensor
    from repro_torch.serving import Request, ServingEngine

    jmodel, sparams, tmodel, tsparams = models
    assert isinstance(tsparams["layers"][0]["attn"]["wq"], SparseQTensor)
    jcfg = jd.IntegerLinConfig(policy=policy, acc_bits=12, k_tile=16,
                               backend="jnp")
    tcfg = td.IntegerLinConfig(policy=policy, acc_bits=12, k_tile=16)
    r = np.random.default_rng(8)
    prompts = [r.integers(0, 256, size=int(r.integers(5, 9))).astype(
        np.int32) for _ in range(3)]
    jeng = JServingEngine(jmodel, sparams, num_slots=3, max_len=32,
                          int_lin=jcfg)
    teng = ServingEngine(tmodel, tsparams, num_slots=3, max_len=32,
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
        # traced inside the context, which is read at trace time; a new
        # function per test, so no trace of the other policy is reused
        caches = jmodel.init_caches(sparams, 3, 32, jnp.float32)
        jp, caches = jax.jit(lambda *a: jmodel.prefill(*a))(
            sparams, jnp.asarray(toks), caches, jnp.asarray(lengths))
        jdec, _ = jax.jit(lambda *a: jmodel.decode(*a))(
            sparams, jnp.asarray(nxt), caches)
    with torch.no_grad(), td.integer_lin(tcfg):
        caches = tmodel.init_caches(tsparams, 3, 32, torch.float32)
        tp, caches = tmodel.prefill(tsparams, torch.from_numpy(toks), caches,
                                    torch.from_numpy(lengths))
        tdec, _ = tmodel.decode(tsparams, torch.from_numpy(nxt), caches)
    for j, t in ((jp, tp), (jdec, tdec)):
        assert np.isfinite(t.numpy()).all()
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
