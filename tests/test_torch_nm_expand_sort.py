"""The expand twins of the global-sort kernels on N:M compressed storage in
the port, against the JAX package, bit-identical on every integer path.

On the CPU each expand kernel wrapper runs its plain version, which
decompresses the slabs (``nm_decompress``'s scatter-add) and runs the
dense plain version over the policy's padded K. Each is held against its
Pallas kernel run in interpret mode (blocks of 8 x 8), which expands the
slabs by its one-hot einsum: the one-pass ``nm_sort_matmul`` under both
policies, the two-pass ``nm_tile_sums_matmul`` and
``nm_paired_accum_matmul`` (fed the JAX package's own permutation),
``nm_chunked_sort_matmul`` and the entry point ``nm_stream_sort_matmul``;
and against the gather twins and the dense plain versions. Inputs are
seeded with numpy (``test_torch_nm_sort._case``: a saturating row, an
all-zero row, a row of repeated tiles for tied tile sums) over 8:16, a
ragged 3:16, 2:4 and the dense-as-sparse 16:16, rounds 1 and 2. The
routing (``nm_policy_matmul`` and ``pqs_dot(storage="nm",
nm_impl="expand")``, ``auto`` below ``GATHER_MIN_G`` groups and at
n_keep = m) and a smoke ``ServingEngine`` with ``nm_impl="expand"`` are
held against the JAX package too. The CUDA kernels are held against these
plain versions on the card by tests/test_torch_cuda.py (marker ``cuda``)
and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.core import dispatch as jd
from repro.core import qtensor as jqt
from repro.core.sorted_accum import pair_permutation as jpair_permutation
from repro.kernels import nm_spmm as jnm
from repro.kernels import ops as jops
from repro.kernels import sorted_stream as jss
from repro_torch.core import dispatch as td
from repro_torch.core.sorted_accum import pair_permutation
from repro_torch.kernels import nm_spmm
from repro_torch.kernels import ops
from repro_torch.kernels import sorted_matmul as tsm
from repro_torch.kernels import sorted_stream as tss
from test_torch_nm_sort import BLOCKS, _case, _jax_slabs, _t, _to_numpy

# (n_keep, m, K, k_tile, acc_bits, rounds): 8:16 at whole tiles with tied
# sums, a ragged 3:16 (K = 300: G = 19, a tail tile of groups past G) and
# 2:4; each case one Pallas compile. The two-pass and chunked kernels on
# the ragged 3:16 run in test_stream_sort_matmul_matches_pallas.
TILED = ((8, 16, 768, 256, 16, 1), (3, 16, 300, 64, 16, 2),
         (2, 4, 192, 64, 12, 1))
SORTED = ((8, 16, 512, 1, 16, 2), (3, 16, 300, 1, 12, 1))


def _tied(k, k_tile):
    return k_tile if k % k_tile == 0 else None


@pytest.mark.parametrize("case", TILED, ids=str)
def test_sort_matmul_sorted_tiled_matches_pallas(case):
    n_keep, m, k, k_tile, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 8, k, n_keep, m, k + 1, _tied(k, k_tile))
    kp = ops.padded_k(vals.shape[1] * m, "sorted_tiled", k_tile)
    kw = dict(policy="sorted_tiled", acc_bits=acc_bits, k_tile=k_tile,
              rounds=rounds)
    want = jnm.nm_sort_matmul(*_jax_slabs(x, vals, idx, m, kp, True),
                              m_group=m, **kw, **BLOCKS)
    got = nm_spmm.nm_sort_matmul(*_t(x, vals, idx), m_group=m, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", SORTED, ids=str)
def test_sort_matmul_sorted_matches_pallas(case):
    n_keep, m, k, _, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 8, k, n_keep, m, k + 2)
    kp = ops.padded_k(vals.shape[1] * m, "sorted", 1)
    kw = dict(policy="sorted", acc_bits=acc_bits, rounds=rounds)
    want = jnm.nm_sort_matmul(*_jax_slabs(x, vals, idx, m, kp, False),
                              m_group=m, **kw, **BLOCKS)
    got = nm_spmm.nm_sort_matmul(*_t(x, vals, idx), m_group=m, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", TILED[::2], ids=str)
def test_two_pass_kernels_match_pallas(case):
    """Pass 1 exactly, the permutation of its sums exactly, and pass 2 on
    the JAX package's own permutation."""
    n_keep, m, k, k_tile, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 16, k, n_keep, m, k + 3, _tied(k, k_tile))
    kp = ops.padded_k(vals.shape[1] * m, "sorted_tiled", k_tile)
    jx, jv, ji = _jax_slabs(x, vals, idx, m, kp, True)
    tx, tv, ti = _t(x, vals, idx)
    jsums = jss.nm_tile_sums_matmul(jx, jv, ji, m_group=m, k_tile=k_tile,
                                    **BLOCKS)
    sums = tss.nm_tile_sums_matmul(tx, tv, ti, m_group=m, k_tile=k_tile)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))
    jperm = jpair_permutation(jsums)
    np.testing.assert_array_equal(pair_permutation(sums).numpy(),
                                  np.asarray(jperm))
    perm = torch.tensor(np.asarray(jperm), dtype=torch.int32)
    kw = dict(acc_bits=acc_bits, k_tile=k_tile, rounds=rounds, m_group=m)
    want = jss.nm_paired_accum_matmul(jx, jv, ji, jperm, **kw, **BLOCKS)
    got = tss.nm_paired_accum_matmul(tx, tv, ti, perm, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", SORTED[:1], ids=str)
def test_chunked_sort_matmul_matches_pallas(case):
    n_keep, m, k, _, acc_bits, rounds = case
    x, _, vals, idx = _case(8, 16, k, n_keep, m, k + 4)
    kp = ops.padded_k(vals.shape[1] * m, "sorted", 1)
    kw = dict(acc_bits=acc_bits, rounds=rounds, m_group=m)
    want = jss.nm_chunked_sort_matmul(
        *_jax_slabs(x, vals, idx, m, kp, False), bc=4, **kw, **BLOCKS)
    got = tss.nm_chunked_sort_matmul(*_t(x, vals, idx), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("policy", ["sorted_tiled", "sorted"])
def test_stream_sort_matmul_matches_pallas(policy):
    """The two-pass entry point (pass 1, the pairing, pass 2; or the
    chunked sort) on ragged 3:16 slabs, as the JAX package's
    ``nm_stream_sort_matmul`` runs it in interpret mode."""
    m, k_tile = 16, 64
    x, _, vals, idx = _case(8, 8, 300, 3, m, 5)
    kp = ops.padded_k(vals.shape[1] * m, policy, k_tile)
    kw = dict(policy=policy, acc_bits=13, k_tile=k_tile, rounds=2, m_group=m)
    want = jss.nm_stream_sort_matmul(
        *_jax_slabs(x, vals, idx, m, kp, policy == "sorted_tiled"), **kw,
        **BLOCKS)
    got = tss.nm_stream_sort_matmul(*_t(x, vals, idx), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_keep,m", [(2, 4), (8, 16), (3, 16), (16, 16)])
def test_plain_twins_equal_gather_and_dense(n_keep, m):
    """Every expand plain version equals its gather twin and the dense
    plain version on the decompressed weight over the same kp, ragged K
    and tied tile sums included, at acc_bits 12 and 16, rounds 1 and 2;
    one-pass equals two-pass."""
    for k, k_tile in ((256, 64), (300, 64)):
        x, wd, vals, idx = _case(5, 9, k, n_keep, m, k + n_keep,
                                 _tied(k, k_tile))
        tx, tw, tv, ti = _t(x, wd, vals, idx)
        g = vals.shape[1]
        kt = ops.padded_k(g * m, "sorted_tiled", k_tile)
        ks = ops.padded_k(g * m, "sorted", k_tile)
        nk = dict(m_group=m, k_tile=k_tile)
        sums = tss.nm_tile_sums_matmul(tx, tv, ti, **nk)
        for want in (tss.nm_gather_tile_sums(tx, tv, ti, **nk),
                     tss.tile_sums_matmul(tx, tw, k_tile=k_tile, kp=kt)):
            np.testing.assert_array_equal(sums.numpy(), want.numpy())
        perm = pair_permutation(sums).to(torch.int32)
        for acc_bits in (12, 16):
            for rounds in (1, 2):
                kw = dict(acc_bits=acc_bits, rounds=rounds)
                tk = dict(kw, k_tile=k_tile)
                dense = tsm.sort_matmul(tx, tw, policy="sorted_tiled", kp=kt,
                                        **tk).numpy()
                for got in (
                        nm_spmm.nm_sort_matmul(tx, tv, ti, m_group=m,
                                               policy="sorted_tiled", **tk),
                        nm_spmm.nm_gather_sort_matmul(
                            tx, tv, ti, m_group=m, policy="sorted_tiled",
                            **tk),
                        tss.nm_paired_accum_matmul(tx, tv, ti, perm,
                                                   m_group=m, **tk),
                        tss.nm_stream_sort_matmul(tx, tv, ti, m_group=m,
                                                  policy="sorted_tiled",
                                                  **tk)):
                    np.testing.assert_array_equal(got.numpy(), dense,
                                                  err_msg=f"{k} {kw}")
                dense = tsm.sort_matmul(tx, tw, policy="sorted", kp=ks,
                                        **kw).numpy()
                for got in (
                        nm_spmm.nm_sort_matmul(tx, tv, ti, m_group=m,
                                               policy="sorted", **kw),
                        nm_spmm.nm_gather_sort_matmul(
                            tx, tv, ti, m_group=m, policy="sorted", **kw),
                        tss.nm_chunked_sort_matmul(tx, tv, ti, m_group=m,
                                                   **kw)):
                    np.testing.assert_array_equal(got.numpy(), dense,
                                                  err_msg=f"{k} {kw}")


def test_plain_twins_keep_position_0_under_padded_slots():
    """Slabs whose slot 0 keeps a value at position 0 of its group and
    whose other slots are padding (value 0, index 0, the repeat that
    nm_assert_canonical allows): the padding adds nothing, so the kept
    value stands, as in the JAX package's one-hot expand and in the dense
    kernel on that weight."""
    m = 16
    x, _, vals, idx = _case(8, 8, 64, 8, m, 31)
    vals[:, :, 1:] = 0
    idx[:, :, :] = 0
    tx, tv, ti = _t(x, vals, idx)
    w = torch.zeros((8, 64), dtype=torch.int8)
    w[:, ::m] = tv[:, :, 0]
    for policy, k_tile in (("sorted", 1), ("sorted_tiled", 32)):
        kw = dict(policy=policy, acc_bits=12, k_tile=k_tile, rounds=1)
        got = nm_spmm.nm_sort_matmul(tx, tv, ti, m_group=m, **kw)
        np.testing.assert_array_equal(got.numpy(), tsm.sort_matmul(
            tx, w, **kw).numpy())
    want = jnm.nm_sort_matmul(*_jax_slabs(x, vals, idx, m, 64, False),
                              m_group=m, **kw, **BLOCKS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel", ["sort_matmul[sorted]",
                                    "sort_matmul[sorted_tiled]",
                                    "tile_sums", "paired_accum",
                                    "chunked_sort_matmul"])
def test_kp_extends_with_zero_groups(kernel):
    """Each expand wrapper given x of K = 300 and 3:16 slabs (G = 19, 304
    columns) accumulates over the policy's padded K (320 under
    sorted_tiled at k_tile 64, 512 under sorted), the groups past G being
    zero products: it equals the wrapper on x and slabs zero-padded to
    that kp. An x wider than kp raises."""
    m = 16
    x, _, vals, idx = _case(5, 9, 300, 3, m, 12)
    tx, tv, ti = _t(x, vals, idx)
    policy = "sorted" if kernel in ("sort_matmul[sorted]",
                                    "chunked_sort_matmul") else "sorted_tiled"
    kp = ops.padded_k(19 * m, policy, 64)
    assert kp > 19 * m
    pad = (0, 0, 0, kp // m - 19)
    px = ops._pad_to(tx, kp, 1)
    pv, pi = (torch.nn.functional.pad(a, pad) for a in (tv, ti))
    perm = pair_permutation(tss.nm_tile_sums_matmul(
        px, pv, pi, m_group=m, k_tile=64)).to(torch.int32)
    calls = {
        "sort_matmul[sorted]": lambda a, v, i: nm_spmm.nm_sort_matmul(
            a, v, i, m_group=m, acc_bits=13, rounds=2),
        "sort_matmul[sorted_tiled]": lambda a, v, i: nm_spmm.nm_sort_matmul(
            a, v, i, m_group=m, acc_bits=13, policy="sorted_tiled",
            k_tile=64),
        "tile_sums": lambda a, v, i: tss.nm_tile_sums_matmul(
            a, v, i, m_group=m, k_tile=64),
        "paired_accum": lambda a, v, i: tss.nm_paired_accum_matmul(
            a, v, i, perm, m_group=m, acc_bits=13, k_tile=64),
        "chunked_sort_matmul": lambda a, v, i: tss.nm_chunked_sort_matmul(
            a, v, i, m_group=m, acc_bits=13),
    }
    call = calls[kernel]
    np.testing.assert_array_equal(call(tx, tv, ti).numpy(),
                                  call(px, pv, pi).numpy())
    with pytest.raises(ValueError):
        call(ops._pad_to(tx, kp + 1, 1), tv, ti)


def _count_routes(monkeypatch):
    """Record which global-sort entry of ``ops`` each call reaches."""
    calls = []
    for name in ("nm_sort_matmul", "nm_stream_sort_matmul",
                 "nm_gather_sort_matmul", "nm_gather_stream_sort_matmul"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("policy", ["sorted", "sorted_tiled"])
def test_pqs_dot_nm_expand_matches_jax(monkeypatch, policy):
    """K ragged (300 under 4:16: G = 19), ragged M and N: JAX's
    pqs_dot(storage="nm", nm_impl="expand", backend="pallas") equals the
    port's pqs_dot with nm_impl="expand" on a SparseQTensor and on a bare
    pair for every sort_impl, each reaching the expand entry the route
    names (one-pass nm_sort_matmul, two-pass nm_stream_sort_matmul)."""
    from repro_torch.core.qtensor import SparseQTensor

    m = 16
    x, _, vals, idx = _case(5, 9, 300, 4, m, 6)
    kw = dict(acc_bits=14, policy=policy, k_tile=64)
    want = np.asarray(jd.pqs_dot(
        jnp.asarray(x), jqt.SparseQTensor(jnp.asarray(vals),
                                          jnp.asarray(idx),
                                          jnp.ones(9, jnp.float32), m, 300),
        storage="nm", backend="pallas", nm_impl="expand", **kw))
    tx, tv, ti = _t(x, vals, idx)
    sq = SparseQTensor(tv, ti, torch.ones(9), m, 300)
    xg = ops._pad_to(tx, 19 * m, 1)
    calls = _count_routes(monkeypatch)
    for impl in ops.SORT_IMPLS:
        entry = ("nm_stream_sort_matmul" if impl == "twopass"
                 else "nm_sort_matmul")
        calls.clear()
        # the CUDA backend's path, which CPU tensors run through the plain
        # versions of the kernels
        kernels = td._local_dot(xg, (tv, ti), acc_bits=14, policy=policy,
                                k_tile=64, rounds=1, backend="cuda",
                                batch_chunk=None, m_group=m, sort_impl=impl,
                                nm_impl="expand")
        assert calls == [entry], (impl, calls)
        for got in (kernels,
                    td.pqs_dot(tx, sq, storage="nm", sort_impl=impl,
                               nm_impl="expand", **kw),
                    td.pqs_dot(xg, (tv, ti), storage="nm", m_group=m,
                               sort_impl=impl, nm_impl="expand", **kw)):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)


def test_pqs_dot_nm_expand_above_resident_k_matches_jax():
    """K = 4500 (3 x 9 x 4500 at 8:16): padded K above MAX_RESIDENT_K, so
    auto takes the two-pass expand route under ``sorted_tiled``; every
    sort_impl gives JAX's pqs_dot(storage="nm", nm_impl="expand") through
    its two-pass expand kernels in interpret mode."""
    m = 16
    x, _, vals, idx = _case(3, 9, 4500, 8, m, 22)
    xg = np.pad(x, ((0, 0), (0, vals.shape[1] * m - 4500)))
    tx, tv, ti = _t(xg, vals, idx)
    kw = dict(acc_bits=16, policy="sorted_tiled", k_tile=256)
    assert ops.padded_k(4512, "sorted_tiled", 256) > ops.MAX_RESIDENT_K
    want = np.asarray(jd.pqs_dot(
        jnp.asarray(xg), (jnp.asarray(vals), jnp.asarray(idx)),
        storage="nm", m_group=m, backend="pallas", nm_impl="expand", **kw))
    for impl in ops.SORT_IMPLS:
        got = ops.nm_policy_matmul(tx, tv, ti, m_group=m, sort_impl=impl,
                                   nm_impl="expand", **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)


@pytest.mark.parametrize("policy", ["sorted", "sorted_tiled"])
def test_auto_takes_expand_at_few_groups_and_dense_as_sparse(monkeypatch,
                                                             policy):
    """``auto`` resolves to expand below GATHER_MIN_G groups (K = 112 at
    m = 16: G = 7) and for dense-as-sparse storage (16:16), as the JAX
    package resolves it, and reaches the expand entry with the dense
    result; explicit gather still takes the gather entry."""
    calls = _count_routes(monkeypatch)
    for k, n_keep in ((112, 8), (256, 16)):
        x, wd, vals, idx = _case(4, 6, k, n_keep, 16, k + n_keep)
        tx, tw, tv, ti = _t(x, wd, vals, idx)
        g = vals.shape[1]
        assert ops.resolve_nm_impl(policy, g, n_keep, 16) == "expand"
        assert jops.resolve_nm_impl(policy, g, n_keep, 16) == "expand"
        kw = dict(policy=policy, acc_bits=12, k_tile=32)
        want = tsm.sort_matmul(tx, tw, kp=ops.padded_k(g * 16, policy, 32),
                               **kw)
        for impl, entry in ((None, "nm_sort_matmul"),
                            ("gather", "nm_gather_sort_matmul")):
            calls.clear()
            got = ops.nm_policy_matmul(tx, tv, ti, m_group=16, nm_impl=impl,
                                       **kw)
            assert calls == [entry], (k, impl, calls)
            assert torch.equal(got, want), (k, impl)


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
    qparams = jax.jit(lambda p: jqt.quantize_tree(
        p, bits=8, n_keep=8, m=16, min_size=1 << 12, min_dim=16))(
            jmodel.init(jax.random.PRNGKey(1)))
    sparams = jqt.nm_compress_tree(qparams, 8, 16)
    tmodel = build_model(dataclasses.replace(
        get_config("qwen2-1.5b", smoke=True), compute_dtype="float32"),
        device="cpu")
    return jmodel, sparams, tmodel, params_from_numpy(_to_numpy(sparams),
                                                      device="cpu")


def _through_kernel_path(monkeypatch):
    """Route the compressed projections of pqs_dot through the CUDA
    backend's path (``ops.nm_policy_matmul``), which CPU tensors run
    through the plain versions of the kernels; the torch backend would
    decompress them to the dense plain version instead. x arrives padded
    to the policy's kp and is cut back to the slabs' G * m_group (the
    columns past it are zeros)."""
    local_dot = td._local_dot

    def kernel_path(x2, w, *, backend, m_group=None, **kw):
        if m_group is not None:
            backend, x2 = "cuda", x2[:, : w[0].shape[1] * m_group]
        return local_dot(x2, w, backend=backend, m_group=m_group, **kw)

    monkeypatch.setattr(td, "_local_dot", kernel_path)


@pytest.mark.parametrize("policy", ["sorted_tiled", "sorted"])
def test_engine_compressed_expand_matches_jax(models, monkeypatch, policy):
    """Greedy tokens of the port's engine on compressed weights with
    ``nm_impl="expand"`` equal the JAX engine's, under a global-sort policy
    at a 12-bit register (k_tile 16: several tiles a site, so the pairing
    runs), every compressed projection reaching the expand twins on the
    kernels' path."""
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import Request, ServingEngine

    jmodel, sparams, tmodel, tsparams = models
    _through_kernel_path(monkeypatch)
    jcfg = jd.IntegerLinConfig(policy=policy, acc_bits=12, k_tile=16,
                               backend="jnp")
    tcfg = td.IntegerLinConfig(policy=policy, acc_bits=12, k_tile=16,
                               nm_impl="expand")
    r = np.random.default_rng(9)
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
    calls = _count_routes(monkeypatch)
    jeng.drain(jreqs)
    teng.drain(treqs)
    assert [q.output for q in treqs] == [q.output for q in jreqs]
    assert calls and set(calls) <= {"nm_sort_matmul",
                                    "nm_stream_sort_matmul"}, set(calls)
