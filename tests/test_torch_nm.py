"""N:M compressed storage in the port against the JAX package.

Inputs are seeded with numpy and reach both packages as arrays. Integer
results are held exact; logits to 1e-4, as in tests/test_torch_serving.py
(XLA and torch sum float matmuls in different orders).

The plain versions of the two N:M kernels are held against the JAX
package's Pallas kernels in interpret mode (``ops.nm_policy_matmul`` with
``nm_impl="expand"`` and ``"gather"``, as tests/test_nm_policy.py runs
them) and against the port's dense path on the decompressed weight, which
tests/test_torch_kernels.py holds bit-exact against JAX. Every
combination of policy, (n_keep, m), acc_bits, rounds and k_tile goes
through the dense path; an interpret-mode kernel call costs about half a
second, so each of those calls takes one combination in turn, and
together they cover each combination at least once.
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
from repro.kernels import ops as jops
from repro_torch.core import dispatch as td
from repro_torch.core import pruning as tpr
from repro_torch.core import qtensor as tqt
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import ops as tops

NM_SHAPES = ((2, 4), (4, 8), (4, 16), (8, 16))  # (n_keep, m)
SEQ = ("wide", "clip", "wrap", "sorted_tiled_seq")
POLICIES = SEQ[:3] + ("sorted", "sorted_tiled", "sorted_tiled_seq")
ATOL = 1e-4


def _slabs(n, k, n_keep, m, seed):
    """(dense, values, indices) from the JAX packer: a seeded int8 matrix
    pruned n_keep:m by the JAX mask (tail group zero-padded)."""
    r = np.random.default_rng(seed)
    kp = k + (-k) % m
    wd = np.pad(r.integers(-127, 128, (n, k)), ((0, 0), (0, kp - k)))
    mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(wd, jnp.float32),
                                        n_keep, m))
    wd = (wd * mask).astype(np.int8)[:, :k]
    vals, idx = jpr.nm_compress(wd, n_keep, m)
    return wd, vals, idx


def _x(m, k, seed):
    x = np.random.default_rng(seed + 100).integers(-127, 128, (m, k))
    x[0] = 127  # a row whose registers saturate
    return x.astype(np.int8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_keep,m,k", [(2, 4, 96), (4, 8, 100),
                                        (4, 16, 96), (8, 16, 100),
                                        (16, 16, 100)])
def test_nm_compress_matches_jax(n_keep, m, k):
    """Same survivors, order and padding as both JAX packers (ragged K,
    dense-as-sparse at n_keep == m, leading dims); exact round trip."""
    wd, vals, idx = _slabs(6, k, n_keep, m, seed=n_keep + m + k)
    tv, ti = tpr.nm_compress(torch.from_numpy(wd), n_keep, m)
    assert tv.dtype == torch.int8 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), vals)
    np.testing.assert_array_equal(ti.numpy(), idx)
    tpr.nm_assert_canonical(tv, ti, m, k=k)
    np.testing.assert_array_equal(tpr.nm_decompress(tv, ti, m, k=k).numpy(),
                                  wd)
    stacked = np.stack([wd, -wd])
    jv, ji = jpr.nm_compress_jax(jnp.asarray(stacked), n_keep, m)
    sv, si = tpr.nm_compress(torch.from_numpy(stacked), n_keep, m)
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        tpr.nm_decompress(sv, si, m).numpy(),
        np.asarray(jpr.nm_decompress_jax(jv, ji, m)))


def test_nm_compress_ties_and_raise():
    """Tied magnitudes keep the lower positions, groups with fewer
    nonzeros pad with zero-valued slots, as in JAX; a group denser than
    n_keep raises in both packages."""
    w = np.array([[2, -2, 0, 2, 0, 0, 0, 0],
                  [0, 0, 0, 0, 0, 0, 0, 0],
                  [-3, 0, 3, 0, 0, 3, 0, 0]], np.int8)
    jv, ji = jpr.nm_compress(w, 3, 8)
    tv, ti = tpr.nm_compress(torch.from_numpy(w), 3, 8)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    dense = np.array([[1, 2, 3, 0]], np.int8)
    with pytest.raises(ValueError, match="sparse"):
        jpr.nm_compress(dense, 2, 4)
    with pytest.raises(ValueError, match="sparse"):
        tpr.nm_compress(torch.from_numpy(dense), 2, 4)
    for bad in ((0, 4), (5, 4), (2, 0)):
        with pytest.raises(ValueError):
            tpr.nm_compress(torch.from_numpy(dense), *bad)


def test_nm_assert_canonical_catches_violations():
    _, vals, idx = _slabs(4, 100, 4, 8, seed=47)
    tv, ti = _t(vals, idx)
    tpr.nm_assert_canonical(tv, ti, 8, k=100)
    bad_v, bad_i = tv.clone(), ti.clone()
    bad_v[0, -1, -1], bad_i[0, -1, -1] = 5, 7  # dense position 103 >= 100
    with pytest.raises(AssertionError, match="tail positions"):
        tpr.nm_assert_canonical(bad_v, bad_i, 8, k=100)
    desc = ti.clone()
    desc[0, 0] = desc[0, 0].flip(0)
    with pytest.raises(AssertionError, match="ascend"):
        tpr.nm_assert_canonical(tv, desc, 8)
    with pytest.raises(AssertionError, match="out of range"):
        tpr.nm_assert_canonical(tv, ti + 8, 8)
    # zero-padded groups (index 0 repeated, value 0) are canonical
    zv = torch.zeros((4, 2, 4), dtype=tv.dtype)
    zi = torch.zeros((4, 2, 4), dtype=ti.dtype)
    tpr.nm_assert_canonical(torch.cat([tv, zv], 1), torch.cat([ti, zi], 1),
                            8)
    # and the scatter-add decompress keeps a kept value at index 0 that a
    # padded slot shares
    v = torch.tensor([[[5, 0]]], dtype=torch.int8)
    i = torch.zeros((1, 1, 2), dtype=torch.int32)
    tpr.nm_assert_canonical(v, i, 4)
    assert tpr.nm_decompress(v, i, 4).tolist() == [[5, 0, 0, 0]]


# ---------------------------------------------------------------------------
# SparseQTensor and the tree conversion
# ---------------------------------------------------------------------------


def test_sparse_qtensor_matches_jax():
    w = np.random.default_rng(1).standard_normal((96, 40)).astype(
        np.float32) * 0.1
    jq = jqt.quantize_weight(jnp.asarray(w), 8, 4, 16)
    tq = tqt.quantize_weight(torch.from_numpy(w), 8, 4, 16)
    js = jqt.qtensor_nm_compress(jq, 4, 16)
    ts = tqt.qtensor_nm_compress(tq, 4, 16)
    for a, b in ((ts.values, js.values), (ts.indices, js.indices),
                 (ts.scale, js.scale)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ts.m_group, ts.k_dim, ts.shape, ts.ndim) == (
        js.m_group, js.k_dim, js.shape, js.ndim)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = ts.dequant(dt)
        assert got.is_contiguous()
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(js.dequant(jdt).astype(jnp.float32)))
        assert torch.equal(got, tq.dequant(dt))  # lossless, same layout
    pos = torch.tensor([[0, 17, 95], [3, 3, 64]])
    rows = ts.input_rows(pos)
    assert rows.is_contiguous()  # the layout of a dense table's rows
    assert torch.equal(rows, tq.values[pos].to(torch.int32))
    # ragged K, dense-as-sparse: the tail group pads inside the slabs
    jr = jqt.qtensor_nm_compress(
        jqt.quantize_weight(jnp.asarray(w[:50, :24]), 8), 16, 16)
    tr = tqt.qtensor_nm_compress(
        tqt.quantize_weight(torch.from_numpy(w[:50, :24]), 8), 16, 16)
    assert tr.k_dim == 50 and tuple(tr.values.shape) == (24, 4, 16)
    np.testing.assert_array_equal(tr.dequant(torch.float32).numpy(),
                                  np.asarray(jr.dequant(jnp.float32)))


def test_nm_compress_tree_matches_jax():
    r = np.random.default_rng(2)
    tree = {"wq": r.standard_normal((64, 32)).astype(np.float32),
            "ragged": r.standard_normal((40, 32)).astype(np.float32),
            "stacked": r.standard_normal((2, 32, 16)).astype(np.float32),
            "bias": r.standard_normal((32,)).astype(np.float32)}
    kw = dict(bits=8, n_keep=4, m=16, min_size=1, min_dim=8)
    jtree = jqt.quantize_tree({k: jnp.asarray(v) for k, v in tree.items()},
                              **kw)
    ttree = tqt.quantize_tree({k: torch.from_numpy(v)
                               for k, v in tree.items()}, device="cpu", **kw)
    js, ts = jqt.nm_compress_tree(jtree, 4, 16), tqt.nm_compress_tree(
        ttree, 4, 16)
    for k in tree:
        for jcls, tcls in ((jqt.SparseQTensor, tqt.SparseQTensor),
                           (jqt.QTensor, tqt.QTensor)):
            assert isinstance(js[k], jcls) == isinstance(ts[k], tcls), k
        if isinstance(js[k], jqt.SparseQTensor):
            np.testing.assert_array_equal(ts[k].values.numpy(),
                                          np.asarray(js[k].values))
            np.testing.assert_array_equal(ts[k].indices.numpy(),
                                          np.asarray(js[k].indices))
    assert isinstance(ts["ragged"], tqt.QTensor)  # 40 % 16: unpruned
    for bad, match in (((17, 16), "n_keep"), ((4, 0), "m_group"),
                       ((2, 16), "no QTensor leaf")):
        with pytest.raises(ValueError, match=match):
            jqt.nm_compress_tree(jtree, *bad)
        with pytest.raises(ValueError, match=match):
            tqt.nm_compress_tree(ttree, *bad)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


def _combos(policy):
    """(acc_bits, rounds, k_tile) combinations that change the result."""
    if policy == "wide":
        return [(16, 1, 32)]
    if policy in ("clip", "wrap"):
        return [(12, 1, 32), (16, 1, 32)]
    return [(a, r, t) for a in (12, 16) for r in (1, 2) for t in (32, 64)]


@pytest.mark.parametrize("shape_i", range(len(NM_SHAPES)))
@pytest.mark.parametrize("policy", SEQ)
def test_plain_versions_match_jax_kernels(policy, shape_i):
    n_keep, m = NM_SHAPES[shape_i]
    M, N, K = 5, 9, 96
    wd, vals, idx = _slabs(N, K, n_keep, m, seed=n_keep * 31 + m)
    x = _x(M, K, seed=m)
    tx, tv, ti = _t(x, vals, idx)
    jx, jv, ji = jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx)
    combos = _combos(policy)
    for c, (acc_bits, rounds, k_tile) in enumerate(combos):
        kw = dict(policy=policy, acc_bits=acc_bits, rounds=rounds,
                  k_tile=k_tile)
        want = td.pqs_dot(tx, torch.from_numpy(wd), **kw).numpy()
        got = {impl: fn(tx, tv, ti, m_group=m, **kw).numpy() for impl, fn in (
            ("expand", nm_spmm.nm_seq_policy_matmul),
            ("gather", nm_spmm.nm_gather_seq_policy_matmul))}
        for impl, out in got.items():
            np.testing.assert_array_equal(out, want, err_msg=f"{impl} {kw}")
            np.testing.assert_array_equal(
                tops.nm_policy_matmul(tx, tv, ti, m_group=m, nm_impl=impl,
                                      **kw).numpy(), want)
        # the interpret-mode Pallas kernels, one combination each in turn
        for j, impl in enumerate(("expand", "gather")):
            if (2 * shape_i + j) % len(combos) == c or len(combos) == 1:
                pallas = jops.nm_policy_matmul(
                    jx, jv, ji, m_group=m, nm_impl=impl, bm=8, bn=16,
                    interpret=True, **kw)
                np.testing.assert_array_equal(got[impl], np.asarray(pallas),
                                              err_msg=f"pallas {impl} {kw}")


@pytest.mark.parametrize("n_keep,m", [(3, 16), (2, 4)])
def test_plain_versions_ragged(n_keep, m):
    """Ragged M, N, K and G, and a tile of L = 3 * bg kept products padded
    to a power of two; against the dense path."""
    M, N, K = 5, 70, 300
    wd, vals, idx = _slabs(N, K, n_keep, m, seed=n_keep + m)
    x = _x(M, K, seed=3)
    tx, tv, ti = _t(x, vals, idx)
    for policy in SEQ:
        for rounds in (1, 2):
            kw = dict(policy=policy, acc_bits=14, rounds=rounds, k_tile=64)
            want = td.pqs_dot(tx, torch.from_numpy(wd), **kw).numpy()
            for fn in (nm_spmm.nm_seq_policy_matmul,
                       nm_spmm.nm_gather_seq_policy_matmul):
                np.testing.assert_array_equal(
                    fn(tx, tv, ti, m_group=m, **kw).numpy(), want,
                    err_msg=f"{fn.__name__} {kw}")


def test_kernel_helpers():
    a = torch.ones((2, 3), dtype=torch.int32)
    assert tuple(nm_spmm.pad_last_pow2(a).shape) == (2, 4)
    assert int(nm_spmm.pad_last_pow2(a)[:, 3].abs().sum()) == 0
    _, vals, idx = _slabs(3, 32, 2, 8, seed=5)
    x = _x(2, 32, seed=5)
    tx, tv, ti = _t(x, vals, idx)
    dense = nm_spmm.expand_nm_slab(tv, ti, 8)
    prods = nm_spmm.gather_nm_products(tx, tv, ti, 8)  # (2, 3, 8)
    full = tx.to(torch.int32)[:, None, :] * dense[None]
    assert torch.equal(prods.sum(-1), full.sum(-1))
    assert int((prods != 0).sum()) == int((full != 0).sum())


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_pqs_dot_nm_equals_dense(policy):
    """A SparseQTensor (ragged K = 100) and a bare pair both give the
    dense result on the decompressed weight, and JAX's."""
    n_keep, m, M, N, K = 4, 16, 4, 6, 100
    wd, vals, idx = _slabs(N, K, n_keep, m, seed=29)
    x = _x(M, K, seed=29)
    tx, tv, ti = _t(x, vals, idx)
    sq = tqt.SparseQTensor(tv, ti, torch.ones(N), m, K)
    kw = dict(acc_bits=14, policy=policy, k_tile=32)
    dense = td.pqs_dot(tx, torch.from_numpy(wd), **kw)
    want = np.asarray(jd.pqs_dot(jnp.asarray(x), jnp.asarray(wd),
                                 backend="jnp", **kw))
    np.testing.assert_array_equal(dense.numpy(), want)
    for impl in (None, "expand", "gather"):
        assert torch.equal(td.pqs_dot(tx, sq, storage="nm", nm_impl=impl,
                                      **kw), dense)
        padded = torch.nn.functional.pad(tx, (0, 112 - K))
        assert torch.equal(td.pqs_dot(padded, (tv, ti), storage="nm",
                                      m_group=m, nm_impl=impl, **kw), dense)
        for backend in ("torch", None):
            assert torch.equal(td.pqs_dot(tx, sq, storage="nm",
                                          backend=backend, **kw), dense)


def test_resolve_nm_impl_matches_jax():
    for policy in SEQ + ("sorted",):
        for g in (jops.GATHER_MIN_G - 1, jops.GATHER_MIN_G, 96):
            for n_keep, m in NM_SHAPES + ((16, 16),):
                for impl in (None, "auto", "expand", "gather"):
                    assert tops.resolve_nm_impl(policy, g, n_keep, m,
                                                impl) == \
                        jops.resolve_nm_impl(policy, g, n_keep, m, impl)
    assert tops.GATHER_MIN_G == jops.GATHER_MIN_G
    with pytest.raises(ValueError, match="nm_impl"):
        tops.resolve_nm_impl("clip", 16, 2, 8, "bogus")


def test_nm_validation_errors():
    _, vals, idx = _slabs(4, 32, 2, 8, seed=0)
    tx, tv, ti = _t(_x(2, 32, 0), vals, idx)
    with pytest.raises(ValueError, match="storage"):
        td.pqs_dot(tx, (tv, ti), storage="csr", m_group=8)
    with pytest.raises(ValueError, match="m_group"):
        td.pqs_dot(tx, (tv, ti), storage="nm")
    with pytest.raises(ValueError, match="k_tile"):
        td.pqs_dot(tx, (tv, ti), storage="nm", m_group=8,
                   policy="sorted_tiled", k_tile=4)
    with pytest.raises(ValueError, match="contraction"):
        td.pqs_dot(tx[:, :24], (tv, ti), storage="nm", m_group=8)
    with pytest.raises(ValueError, match="SparseQTensor"):
        td.pqs_dot(tx, "bogus", storage="nm", m_group=8)
    with pytest.raises(ValueError, match="nm_impl"):
        td.pqs_dot(tx, (tv, ti), storage="nm", m_group=8, nm_impl="bogus")
    with pytest.raises(ValueError, match="storage"):
        td.pqs_dot(tx, tv[:, 0], nm_impl="gather")  # dense w
    with pytest.raises(ValueError, match="contraction"):
        nm_spmm.nm_gather_seq_policy_matmul(tx, tv[:, :2], ti[:, :2],
                                            m_group=8)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


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
def smoke():
    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild_model
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import build_model

    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    qparams = jqt.quantize_tree(jmodel.init(jax.random.PRNGKey(0)), bits=8,
                                n_keep=8, m=16, min_size=1 << 12, min_dim=16)
    sparams = jqt.nm_compress_tree(qparams, 8, 16)
    tmodel = build_model(dataclasses.replace(
        get_config("qwen2-1.5b", smoke=True), compute_dtype="float32"),
        device="cpu")
    return (jmodel, sparams, tmodel,
            params_from_numpy(_to_numpy(qparams), device="cpu"),
            params_from_numpy(_to_numpy(sparams), device="cpu"))


def test_compressed_conversion(smoke):
    _, sparams, _, _, tsparams = smoke
    assert isinstance(tsparams["embed"], tqt.SparseQTensor)
    wq = tsparams["layers"][1]["attn"]["wq"]
    assert isinstance(wq, tqt.SparseQTensor) and wq.k_dim == 48
    np.testing.assert_array_equal(
        wq.indices.numpy(),
        np.asarray(sparams["layers"]["attn"]["wq"].indices[1]))


def test_compressed_logits_match_jax(smoke):
    jmodel, sparams, tmodel, _, tsparams = smoke
    r = np.random.default_rng(1)
    toks = r.integers(0, 256, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 0], np.int32)
    nxt = r.integers(0, 256, (3, 1)).astype(np.int32)
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=16)
    with jd.integer_lin(jd.IntegerLinConfig(backend="jnp", **kw)):
        caches = jmodel.init_caches(sparams, 3, 32, jnp.float32)
        jp, caches = jmodel.prefill(sparams, jnp.asarray(toks), caches,
                                    jnp.asarray(lengths))
        jdl, _ = jmodel.decode(sparams, jnp.asarray(nxt), caches)
    with torch.no_grad(), td.integer_lin(td.IntegerLinConfig(
            nm_impl="gather", **kw)):
        caches = tmodel.init_caches(tsparams, 3, 32, torch.float32)
        tp, caches = tmodel.prefill(tsparams, torch.from_numpy(toks), caches,
                                    torch.from_numpy(lengths))
        tdl, _ = tmodel.decode(tsparams, torch.from_numpy(nxt), caches)
    for t, j in ((tp, jp), (tdl, jdl)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)


def test_compressed_engine_tokens(smoke):
    """JAX's engine on its compressed params, and the port's on the
    converted ones (both kernels) and on the dense QTensors, give the same
    greedy tokens."""
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import Request, ServingEngine

    jmodel, sparams, tmodel, tqparams, tsparams = smoke
    r = np.random.default_rng(2)
    prompts = [r.integers(0, 256, size=int(r.integers(3, 12))).astype(
        np.int32) for _ in range(5)]
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=16)
    eng = JServingEngine(jmodel, sparams, num_slots=3, max_len=64,
                         int_lin=jd.IntegerLinConfig(backend="jnp", **kw))
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    eng.drain(reqs)
    want = [q.output for q in reqs]
    for params, impl in ((tsparams, "gather"), (tsparams, "expand"),
                         (tqparams, None)):
        eng = ServingEngine(tmodel, params, num_slots=3, max_len=64,
                            device="cpu", int_lin=td.IntegerLinConfig(
                                nm_impl=impl, **kw))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.drain(reqs)
        assert [q.output for q in reqs] == want, impl
