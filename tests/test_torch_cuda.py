"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. This file imports no JAX, so it runs where only the port is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.dispatch import pqs_dot
from repro_torch.core.pruning import nm_compress, nm_decompress, nm_prune_mask
from repro_torch.core.sorted_accum import pair_permutation
from repro_torch.kernels import nm_spmm, ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.kernels import sorted_matmul as sm
from repro_torch.kernels import sorted_stream as ss

# the slab builders of chip_smoke.py's duplicate-slot phase
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    DotRecorder,
    smallest_duplicate,
    stacked_slabs,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _xw(m, k, n, seed, card):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.integers(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(r.integers(-127, 128, (n, k)).astype(np.int8))
    x[0] = 127  # a saturating row
    w[0] = 127
    return x.to(card), w.to(card)


@pytest.mark.parametrize("policy", sm.SEQ_POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16, 24])
def test_kernel_matches_plain(card, policy, acc_bits):
    for m, k, n in ((5, 300, 70), (64, 1536, 256), (4, 8960, 1536),
                    (33, 1, 9)):
        x, w = _xw(m, k, n, m + n + acc_bits, card)
        for rounds in (1, 2):
            kw = dict(policy=policy, acc_bits=acc_bits, rounds=rounds,
                      k_tile=256)
            got = sm.seq_policy_matmul(x, w, **kw)
            want = sm.seq_policy_matmul_ref(x, w, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (policy, m, k, n, rounds)


@pytest.mark.parametrize("k_tile", [1, 4, 16, 32, 64, 512, 1024])
def test_kernel_every_k_tile(card, k_tile):
    x, w = _xw(6, 2048 + 5, 40, k_tile, card)
    for rounds in (1, 2):
        kw = dict(policy="sorted_tiled_seq", acc_bits=16, rounds=rounds,
                  k_tile=k_tile)
        assert torch.equal(sm.seq_policy_matmul(x, w, **kw),
                           sm.seq_policy_matmul_ref(x, w, **kw))


def test_kernel_counts_launches_and_checks_inputs(card):
    x, w = _xw(4, 64, 8, 0, card)
    before = sm.seq_policy_matmul.launches
    sm.seq_policy_matmul(x, w, policy="clip")
    assert sm.seq_policy_matmul.launches == before + 1
    # an int32 carrier of int8 values is taken; wider values are refused
    sm.seq_policy_matmul(x.to(torch.int32), w, policy="wide")
    with pytest.raises(ValueError):
        sm.seq_policy_matmul(x.to(torch.int32) * 300, w, policy="wide")
    with pytest.raises(ValueError):
        sm.seq_policy_matmul(x, w.cpu(), policy="wide")
    with pytest.raises(ValueError):
        sm.seq_policy_matmul(x.t().contiguous().t(), w, policy="wide")
    with pytest.raises(NotImplementedError):
        sm.seq_policy_matmul(x, w, policy="sorted_tiled_seq", k_tile=2048)


def _tied(x, w, k_tile):
    """Row 1 of x all zero (every tile sum 0), row 2 of x and of w one
    k_tile pattern repeated (every tile sum of output (2, 2) equal)."""
    x[1] = 0
    if x.shape[0] > 2 and w.shape[0] > 2:
        x[2] = x[2, :k_tile].repeat(x.shape[1] // k_tile)
        w[2] = w[2, :k_tile].repeat(w.shape[1] // k_tile)
    return x, w


# (M, K, N): K a power of 2 for sorted, a multiple of k_tile for sorted_tiled
SORT_CASES = {
    "sorted": ((5, 256, 70), (64, 2048, 256), (4, 2048, 1536), (3, 1, 9)),
    "sorted_tiled": ((5, 320, 70), (64, 1536, 256), (4, 8960, 1536),
                     (3, 256, 9)),
}


@pytest.mark.parametrize("policy", sm.SORT_POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16, 24])
def test_sort_matmul_matches_plain(card, policy, acc_bits):
    for m, k, n in SORT_CASES[policy]:
        k_tile = 64 if k == 320 else min(256, k)
        x, w = _tied(*_xw(m, k, n, m + n + acc_bits, card), k_tile)
        for rounds in (1, 2):
            kw = dict(policy=policy, acc_bits=acc_bits, rounds=rounds,
                      k_tile=k_tile)
            got = sm.sort_matmul(x, w, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, sm.sort_matmul_ref(x, w, **kw)), (
                policy, m, k, n, rounds)


@pytest.mark.parametrize("k_tile", [1, 4, 16, 32, 64, 512, 1024])
def test_tiled_kernels_every_k_tile(card, k_tile):
    """sort_matmul and the two-pass pair, every tile size, odd tile
    counts included (K = 3 * 1024)."""
    x, w = _tied(*_xw(6, 3072, 40, k_tile, card), k_tile)
    for rounds in (1, 2):
        kw = dict(acc_bits=16, rounds=rounds, k_tile=k_tile)
        want = sm.sort_matmul_ref(x, w, policy="sorted_tiled", **kw)
        assert torch.equal(sm.sort_matmul(x, w, policy="sorted_tiled", **kw),
                           want), (k_tile, rounds)
        assert torch.equal(ss.stream_sort_matmul(x, w, policy="sorted_tiled",
                                                 **kw), want), (k_tile, rounds)


def test_stream_kernels_match_plain(card):
    for m, k, n in ((5, 320, 70), (64, 1536, 256), (4, 8960, 1536)):
        k_tile = 64 if k == 320 else 256
        x, w = _tied(*_xw(m, k, n, m + n, card), k_tile)
        sums = ss.tile_sums_matmul(x, w, k_tile=k_tile)
        assert torch.equal(sums, ss.tile_sums_matmul_ref(x, w, k_tile=k_tile))
        perm = pair_permutation(sums).to(torch.int32)
        for rounds in (1, 2):
            kw = dict(acc_bits=16, rounds=rounds, k_tile=k_tile)
            got = ss.paired_accum_matmul(x, w, perm, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ss.paired_accum_matmul_ref(x, w, perm,
                                                               **kw))
    for m, k, n in ((5, 256, 70), (4, 16384, 1536), (64, 2048, 256),
                    (3, 1, 9)):
        x, w = _tied(*_xw(m, k, n, m + n, card), min(k, 256))
        for rounds in (1, 2):
            kw = dict(acc_bits=16, rounds=rounds)
            got = ss.chunked_sort_matmul(x, w, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ss.chunked_sort_matmul_ref(x, w, **kw))
            assert torch.equal(got, sm.sort_matmul(x, w, policy="sorted",
                                                   **kw))


def test_sort_kernels_count_launches_and_check_inputs(card):
    x, w = _xw(4, 256, 8, 0, card)
    perm = pair_permutation(ss.tile_sums_matmul(x, w, k_tile=64)).to(
        torch.int32)
    calls = (
        (sm.sort_matmul, lambda: sm.sort_matmul(x, w, policy="sorted")),
        (ss.tile_sums_matmul, lambda: ss.tile_sums_matmul(x, w, k_tile=64)),
        (ss.paired_accum_matmul, lambda: ss.paired_accum_matmul(
            x, w, perm, k_tile=64)),
        (ss.chunked_sort_matmul, lambda: ss.chunked_sort_matmul(x, w)),
    )
    for kernel, call in calls:
        before = kernel.launches
        call()
        assert kernel.launches == before + 1, kernel.__name__
    with pytest.raises(ValueError):  # sorted needs a power-of-2 K
        sm.sort_matmul(x[:, :200], w[:, :200], policy="sorted")
    with pytest.raises(ValueError):  # k_tile must divide K
        sm.sort_matmul(x, w, policy="sorted_tiled", k_tile=96)
    with pytest.raises(ValueError):
        sm.sort_matmul(x, w.cpu(), policy="sorted")
    with pytest.raises(ValueError):
        ss.chunked_sort_matmul(x.t().contiguous().t(), w)
    with pytest.raises(ValueError):  # perm of the wrong shape
        ss.paired_accum_matmul(x, w, perm[:, :, :2], k_tile=64)
    with pytest.raises(ValueError):
        ss.paired_accum_matmul(x, w, perm.long(), k_tile=64)
    with pytest.raises(ValueError):  # the two-pass slabs are int8
        ops.policy_matmul(x.to(torch.int32) * 300, w, policy="sorted",
                          sort_impl="twopass")
    with pytest.raises(NotImplementedError):
        ss.chunked_sort_matmul(torch.zeros((1, 1 << 17), dtype=torch.int8,
                                           device=card),
                               torch.zeros((1, 1 << 17), dtype=torch.int8,
                                           device=card))


# (M, K, N, k_tile) with K short of the policy's kp: a zero-extended tail
# tile (word and byte loops of pass 1), and the decode sites' K = 1536 and
# 8960 under sorted (kp 2048, 16384)
MASK_CASES = {
    "sort_matmul[sorted]": ((5, 300, 70, 1), (4, 1536, 1536, 1)),
    "sort_matmul[sorted_tiled]": ((5, 1000, 70, 256), (3, 1001, 9, 64)),
    "tile_sums_matmul": ((5, 1000, 70, 256), (3, 1001, 9, 64)),
    "paired_accum_matmul": ((5, 1000, 70, 256), (3, 1001, 9, 64)),
    "chunked_sort_matmul": ((4, 8960, 1536, 1), (3, 5000, 9, 1)),
}


@pytest.mark.parametrize("kernel", sorted(MASK_CASES))
def test_sort_kernels_mask_past_k(card, kernel):
    """Each kernel given K short of kp (no padded copy) gives its plain
    version on operands zero-padded to kp."""
    policy = "sorted" if kernel in ("sort_matmul[sorted]",
                                    "chunked_sort_matmul") else "sorted_tiled"
    for m, k, n, k_tile in MASK_CASES[kernel]:
        x, w = _xw(m, k, n, k + n, card)
        x[1] = 0
        kp = ops.padded_k(k, policy, k_tile)
        px, pw = ops._pad_to(x, kp, 1), ops._pad_to(w, kp, 1)
        for rounds in (1, 2):
            kw = dict(acc_bits=16, rounds=rounds)
            tk = dict(kw, k_tile=k_tile)
            if kernel == "tile_sums_matmul":
                got = ss.tile_sums_matmul(x, w, k_tile=k_tile, kp=kp)
                want = ss.tile_sums_matmul_ref(px, pw, k_tile=k_tile)
            elif kernel == "paired_accum_matmul":
                perm = pair_permutation(ss.tile_sums_matmul_ref(
                    px, pw, k_tile=k_tile)).to(torch.int32)
                got = ss.paired_accum_matmul(x, w, perm, kp=kp, **tk)
                want = ss.paired_accum_matmul_ref(px, pw, perm, **tk)
            elif kernel == "chunked_sort_matmul":
                got = ss.chunked_sort_matmul(x, w, kp=kp, **kw)
                want = ss.chunked_sort_matmul_ref(px, pw, **kw)
            else:
                got = sm.sort_matmul(x, w, policy=policy, kp=kp, **tk)
                want = sm.sort_matmul_ref(px, pw, policy=policy, **tk)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kernel, m, k, n, rounds)


@pytest.mark.parametrize("policy", sm.SORT_POLICIES)
def test_pqs_dot_sort_impls_agree(card, policy):
    """Every sort_impl gives the plain version's result, K ragged, and
    auto launches the one-pass kernel at K <= MAX_RESIDENT_K, the two-pass
    kernels above it; on the card onepass above the bound raises."""
    for m, k, n in ((5, 300, 70), (4, 1536, 256), (3, 4500, 40)):
        x, w = _xw(m, k, n, k, card)
        want = pqs_dot(x, w, policy=policy, k_tile=256, backend="torch")
        kp = ops.padded_k(k, policy, 256)
        for impl in ("auto", "onepass", "twopass"):
            if impl == "onepass" and kp > ops.MAX_RESIDENT_K:
                with pytest.raises(ValueError):
                    pqs_dot(x, w, policy=policy, sort_impl=impl)
                continue
            before = sm.sort_matmul.launches
            got = pqs_dot(x, w, policy=policy, sort_impl=impl)
            assert torch.equal(got, want), (policy, k, impl)
            onepass = impl == "onepass" or (
                impl == "auto" and kp <= ops.MAX_RESIDENT_K)
            assert (sm.sort_matmul.launches == before + 1) == onepass


@pytest.mark.parametrize("policy", ["sorted_tiled_seq", "sorted_tiled",
                                    "sorted"])
def test_engine_kernel_and_plain_agree(card, policy):
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.core.qtensor import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              d_model=128, d_ff=256, num_heads=4,
                              head_dim=32)
    model = build_model(cfg)
    params = quantize_tree(model.init(0), bits=8, n_keep=8, m=16,
                           min_size=1 << 12, min_dim=16)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 256, size=int(r.integers(3, 12))).astype(
        np.int32) for _ in range(4)]
    outs = {}
    for backend in ("cuda", "torch"):
        eng = ServingEngine(model, params, num_slots=3, max_len=64,
                            int_lin=IntegerLinConfig(policy=policy, k_tile=64,
                                                     backend=backend))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.drain(reqs)
        outs[backend] = [q.output for q in reqs]
    assert outs["cuda"] == outs["torch"]


def _prune(w, n_keep, m_group):
    """w n_keep:m_group pruned, and its slabs."""
    k = w.shape[1]
    wp = torch.nn.functional.pad(w, (0, (-k) % m_group)).float()
    w = (wp * nm_prune_mask(wp, n_keep, m_group))[:, :k].to(torch.int8)
    vals, idx = nm_compress(w, n_keep, m_group)
    return w, vals.contiguous(), idx.contiguous()


def _nm_w(m, k, n, n_keep, m_group, seed, card, k_tile=None):
    """Seeded x (m, k), the n_keep:m_group pruned (n, k) weight and its
    slabs; with ``k_tile`` (dividing k), tied tile sums as ``_tied``."""
    x, w = _xw(m, k, n, seed, card)
    if k_tile is not None:
        x, w = _tied(x, w, k_tile)
    return (x, *_prune(w, n_keep, m_group))


def _nm(m, k, n, n_keep, m_group, seed, card):
    """Seeded x (m, k) and n_keep:m_group slabs of an (n, k) weight."""
    x, _, vals, idx = _nm_w(m, k, n, n_keep, m_group, seed, card)
    return x, vals, idx


NM_KERNELS = (
    (nm_spmm.nm_gather_seq_policy_matmul,
     nm_spmm.nm_gather_seq_policy_matmul_ref),
    (nm_spmm.nm_seq_policy_matmul, nm_spmm.nm_seq_policy_matmul_ref),
)


@pytest.mark.parametrize("policy", sm.SEQ_POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16, 24])
def test_nm_kernels_match_plain(card, policy, acc_bits):
    for m, k, n, n_keep, m_group in ((5, 300, 70, 3, 16), (5, 300, 70, 2, 4),
                                     (64, 1536, 256, 8, 16),
                                     (4, 8960, 1536, 8, 16)):
        x, vals, idx = _nm(m, k, n, n_keep, m_group, m + n + acc_bits, card)
        for rounds in (1, 2):
            kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
                      rounds=rounds, k_tile=256)
            for kernel, plain in NM_KERNELS:
                got = kernel(x, vals, idx, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, plain(x, vals, idx, **kw)), (
                    kernel.__name__, m, k, n, n_keep, rounds)


@pytest.mark.parametrize("m_group", [4, 16])
def test_nm_kernels_every_k_tile(card, m_group):
    """Every k_tile from m_group to 1024, with n_keep = 3 (tiles of
    3 * k_tile / m_group kept products, padded to a power of two)."""
    x, vals, idx = _nm(6, 2048 + 5, 40, 3, m_group, m_group, card)
    k_tile = m_group
    while k_tile <= 1024:
        for rounds in (1, 2):
            kw = dict(m_group=m_group, policy="sorted_tiled_seq",
                      acc_bits=16, rounds=rounds, k_tile=k_tile)
            for kernel, plain in NM_KERNELS:
                assert torch.equal(kernel(x, vals, idx, **kw),
                                   plain(x, vals, idx, **kw)), (
                    kernel.__name__, k_tile, rounds)
        k_tile *= 2


def test_nm_kernels_count_launches_and_check_inputs(card):
    x, vals, idx = _nm(4, 64, 8, 2, 8, 0, card)
    for kernel, _ in NM_KERNELS:
        before = kernel.launches
        kernel(x, vals, idx, m_group=8, policy="clip")
        assert kernel.launches == before + 1
        with pytest.raises(ValueError):  # values and indices disagree
            kernel(x, vals[:, :4], idx, m_group=8)
        with pytest.raises(ValueError):  # K past the slabs' G * m
            kernel(torch.nn.functional.pad(x, (0, 8)), vals, idx, m_group=8)
        with pytest.raises(ValueError):
            kernel(x.t().contiguous().t(), vals, idx, m_group=8)
        with pytest.raises(ValueError):
            kernel(x, vals, idx.cpu(), m_group=8)
        with pytest.raises(ValueError):  # k_tile % m_group != 0
            kernel(x, vals, idx, m_group=8, policy="sorted_tiled_seq",
                   k_tile=4)
        with pytest.raises(TypeError):
            kernel(x, vals, idx.long(), m_group=8)
        assert kernel.launches == before + 1
    for policy in ("sorted", "sorted_tiled"):  # the global-sort expand twin
        before = (nm_spmm.nm_sort_matmul.launches,
                  nm_spmm.nm_gather_sort_matmul.launches)
        got = ops.nm_policy_matmul(x, vals, idx, m_group=8, policy=policy,
                                   k_tile=16, nm_impl="expand")
        assert torch.equal(got, nm_spmm.nm_sort_matmul_ref(
            x, vals, idx, m_group=8, policy=policy, k_tile=16)), policy
        assert (nm_spmm.nm_sort_matmul.launches,
                nm_spmm.nm_gather_sort_matmul.launches) == (
                    before[0] + 1, before[1]), policy


def test_engine_compressed_kernels_and_plain_agree(card):
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.core.qtensor import nm_compress_tree, quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              d_model=128, d_ff=256, num_heads=4,
                              head_dim=32)
    model = build_model(cfg)
    params = nm_compress_tree(quantize_tree(
        model.init(0), bits=8, n_keep=8, m=16, min_size=1 << 12,
        min_dim=16), 8, 16)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 256, size=int(r.integers(3, 12))).astype(
        np.int32) for _ in range(4)]
    outs = {}
    for backend, impl in (("cuda", "gather"), ("cuda", "expand"),
                          ("torch", None)):
        eng = ServingEngine(model, params, num_slots=3, max_len=64,
                            int_lin=IntegerLinConfig(k_tile=64,
                                                     backend=backend,
                                                     nm_impl=impl))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.drain(reqs)
        outs[impl] = [q.output for q in reqs]
    assert outs["gather"] == outs["expand"] == outs[None]


# (M, K, N, n_keep, m_group, k_tile): ragged K and G (K = 300 under 3:16
# and 2:4, a tail tile of groups past G), the decode sites' 8:16 slabs at
# K = 1536 and 8960 with tied tile sums, and a prefill-sized M
NM_SORT_CASES = ((5, 300, 70, 3, 16, 64), (5, 300, 70, 2, 4, 256),
                 (64, 1536, 256, 8, 16, 256), (4, 1536, 1536, 8, 16, 256),
                 (4, 8960, 1536, 8, 16, 256))


def _nm_sort_case(case, seed, card):
    m, k, n, n_keep, m_group, k_tile = case
    x, w, vals, idx = _nm_w(m, k, n, n_keep, m_group, seed, card,
                            k_tile if k % k_tile == 0 else None)
    x[1] = 0
    return x, w, vals, idx, m_group, k_tile


@pytest.mark.parametrize("policy", sm.SORT_POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16])
def test_nm_gather_sort_matmul_matches_plain_and_dense(card, policy,
                                                       acc_bits):
    """The one-pass gather kernel equals its plain version, and the dense
    kernel on the decompressed weight over the same kp, given the
    unpadded x and slabs (groups past G and positions past K masked in
    the kernel)."""
    for i, case in enumerate(NM_SORT_CASES):
        x, w, vals, idx, m_group, k_tile = _nm_sort_case(case, i + acc_bits,
                                                         card)
        kp = ops.padded_k(vals.shape[1] * m_group, policy, k_tile)
        for rounds in (1, 2):
            kw = dict(policy=policy, acc_bits=acc_bits, rounds=rounds,
                      k_tile=k_tile)
            got = nm_spmm.nm_gather_sort_matmul(x, vals, idx,
                                                m_group=m_group, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, nm_spmm.nm_gather_sort_matmul_ref(
                x, vals, idx, m_group=m_group, **kw)), (case, rounds)
            assert torch.equal(got, sm.sort_matmul(x, w, kp=kp, **kw)), (
                case, rounds)


def test_nm_gather_stream_kernels_match_plain_and_dense(card):
    """Pass 1, pass 2 and the chunked gather kernels against their plain
    versions and the dense kernels on the decompressed weight; the
    two-pass route equals the one-pass kernel under both policies."""
    for i, case in enumerate(NM_SORT_CASES):
        x, w, vals, idx, m_group, k_tile = _nm_sort_case(case, 40 + i, card)
        g = vals.shape[1]
        kt = ops.padded_k(g * m_group, "sorted_tiled", k_tile)
        ks = ops.padded_k(g * m_group, "sorted", k_tile)
        nkw = dict(m_group=m_group)
        sums = ss.nm_gather_tile_sums(x, vals, idx, k_tile=k_tile, **nkw)
        assert torch.equal(sums, ss.nm_gather_tile_sums_ref(
            x, vals, idx, k_tile=k_tile, **nkw)), case
        assert torch.equal(sums, ss.tile_sums_matmul(x, w, k_tile=k_tile,
                                                     kp=kt)), case
        perm = pair_permutation(sums).to(torch.int32)
        for rounds in (1, 2):
            tk = dict(acc_bits=16, rounds=rounds, k_tile=k_tile)
            two = ss.nm_gather_paired_accum_matmul(x, vals, idx, perm,
                                                   **tk, **nkw)
            torch.cuda.synchronize()
            assert torch.equal(two, ss.nm_gather_paired_accum_matmul_ref(
                x, vals, idx, perm, **tk, **nkw)), (case, rounds)
            assert torch.equal(two, ss.paired_accum_matmul(
                x, w, perm, kp=kt, **tk)), (case, rounds)
            assert torch.equal(two, nm_spmm.nm_gather_sort_matmul(
                x, vals, idx, policy="sorted_tiled", **tk, **nkw))
            assert torch.equal(two, ss.nm_gather_stream_sort_matmul(
                x, vals, idx, policy="sorted_tiled", **tk, **nkw))
            kw = dict(acc_bits=16, rounds=rounds)
            chunked = ss.nm_gather_chunked_sort_matmul(x, vals, idx, **kw,
                                                       **nkw)
            torch.cuda.synchronize()
            assert torch.equal(chunked, ss.nm_gather_chunked_sort_matmul_ref(
                x, vals, idx, **kw, **nkw)), (case, rounds)
            assert torch.equal(chunked, ss.chunked_sort_matmul(x, w, kp=ks,
                                                               **kw))
            assert torch.equal(chunked, nm_spmm.nm_gather_sort_matmul(
                x, vals, idx, policy="sorted", **kw, **nkw))


@pytest.mark.parametrize("kernel", ["sort_matmul[sorted]",
                                    "sort_matmul[sorted_tiled]",
                                    "tile_sums", "paired_accum",
                                    "chunked_sort_matmul"])
def test_nm_gather_kernels_mask_without_host_padding(card, kernel):
    """Given x of K = 300 columns against 3:16 slabs of G = 19 groups (304
    columns), each gather kernel accumulates over the policy's padded K
    (320 under sorted_tiled at k_tile 64, 512 under sorted) and equals its
    plain version on x zero-padded to kp and the slabs zero-padded to
    kp / m groups, with no padded copy passed to the kernel."""
    m_group, k_tile = 16, 64
    x, _, vals, idx = _nm_w(5, 300, 70, 3, m_group, 9, card)
    policy = "sorted" if kernel in ("sort_matmul[sorted]",
                                    "chunked_sort_matmul") else "sorted_tiled"
    kp = ops.padded_k(vals.shape[1] * m_group, policy, k_tile)
    gp = kp // m_group - vals.shape[1]
    assert gp > 0
    px = ops._pad_to(x, kp, 1)
    pv = torch.nn.functional.pad(vals, (0, 0, 0, gp))
    pi = torch.nn.functional.pad(idx, (0, 0, 0, gp))
    kw = dict(m_group=m_group)
    for rounds in (1, 2):
        tk = dict(acc_bits=13, rounds=rounds, k_tile=k_tile, **kw)
        if kernel == "tile_sums":
            got = ss.nm_gather_tile_sums(x, vals, idx, k_tile=k_tile, **kw)
            want = ss.nm_gather_tile_sums_ref(px, pv, pi, k_tile=k_tile, **kw)
        elif kernel == "paired_accum":
            perm = pair_permutation(ss.nm_gather_tile_sums_ref(
                px, pv, pi, k_tile=k_tile, **kw)).to(torch.int32)
            got = ss.nm_gather_paired_accum_matmul(x, vals, idx, perm, **tk)
            want = ss.nm_gather_paired_accum_matmul_ref(px, pv, pi, perm,
                                                        **tk)
        elif kernel == "chunked_sort_matmul":
            got = ss.nm_gather_chunked_sort_matmul(x, vals, idx, acc_bits=13,
                                                   rounds=rounds, **kw)
            want = ss.nm_gather_chunked_sort_matmul_ref(
                px, pv, pi, acc_bits=13, rounds=rounds, **kw)
        else:
            got = nm_spmm.nm_gather_sort_matmul(x, vals, idx, policy=policy,
                                                **tk)
            want = nm_spmm.nm_gather_sort_matmul_ref(px, pv, pi,
                                                     policy=policy, **tk)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kernel, rounds)


def test_nm_gather_sort_kernels_count_launches_and_check_inputs(card):
    x, vals, idx = _nm(4, 256, 8, 2, 8, 0, card)
    perm = pair_permutation(ss.nm_gather_tile_sums(
        x, vals, idx, m_group=8, k_tile=64)).to(torch.int32)
    kw = dict(m_group=8)
    calls = (
        (nm_spmm.nm_gather_sort_matmul, lambda: nm_spmm.nm_gather_sort_matmul(
            x, vals, idx, policy="sorted_tiled", k_tile=64, **kw)),
        (ss.nm_gather_tile_sums, lambda: ss.nm_gather_tile_sums(
            x, vals, idx, k_tile=64, **kw)),
        (ss.nm_gather_paired_accum_matmul,
         lambda: ss.nm_gather_paired_accum_matmul(x, vals, idx, perm,
                                                  k_tile=64, **kw)),
        (ss.nm_gather_chunked_sort_matmul,
         lambda: ss.nm_gather_chunked_sort_matmul(x, vals, idx, **kw)),
    )
    for kernel, call in calls:
        before = kernel.launches
        call()
        assert kernel.launches == before + 1, kernel.__name__
    with pytest.raises(ValueError):  # x wider than the slabs' padded K
        nm_spmm.nm_gather_sort_matmul(ops._pad_to(x, 257, 1), vals, idx,
                                      **kw)
    with pytest.raises(ValueError):  # k_tile % m_group != 0
        ss.nm_gather_tile_sums(x, vals, idx, k_tile=4, **kw)
    with pytest.raises(ValueError):
        ss.nm_gather_tile_sums(x, vals, idx.cpu(), k_tile=64, **kw)
    with pytest.raises(TypeError):
        ss.nm_gather_chunked_sort_matmul(x, vals, idx.long(), **kw)
    with pytest.raises(ValueError):  # perm of the wrong shape
        ss.nm_gather_paired_accum_matmul(x, vals, idx, perm[:, :, :2],
                                         k_tile=64, **kw)
    with pytest.raises(ValueError):
        ss.nm_gather_paired_accum_matmul(x, vals, idx, perm.long(),
                                         k_tile=64, **kw)


def _expand_launches():
    return {f.__name__: f.launches for f in (
        nm_spmm.nm_sort_matmul, ss.nm_tile_sums_matmul,
        ss.nm_paired_accum_matmul, ss.nm_chunked_sort_matmul)}


def _expand_route(policy, kp, sort_impl):
    """The expand kernels one call of ``policy`` over padded K ``kp``
    launches, each once."""
    if sort_impl == "onepass" or (sort_impl == "auto"
                                  and kp <= ops.MAX_RESIDENT_K):
        return {"nm_sort_matmul"}
    if policy == "sorted":
        return {"nm_chunked_sort_matmul"}
    return {"nm_tile_sums_matmul", "nm_paired_accum_matmul"}


def _launched(before, after):
    return {name for name in after if after[name] != before[name]}


@pytest.mark.parametrize("policy", sm.SORT_POLICIES)
def test_nm_policy_matmul_global_sort_on_card(card, policy):
    """Every sort_impl of pqs_dot(storage="nm") runs a gather kernel and
    gives the plain version's result, K ragged; auto takes the one-pass
    kernel at padded K <= MAX_RESIDENT_K; onepass above it raises, as on
    dense storage; nm_impl="expand" gives the same result through the
    expand kernels of its route, and launches no gather or dense one."""
    for m, k, n in ((5, 300, 70), (4, 1536, 256), (3, 4500, 40)):
        x, w, vals, idx = _nm_w(m, k, n, 8, 16, k, card)
        want = pqs_dot(x, w, policy=policy, k_tile=256, backend="torch")
        kp = ops.padded_k(vals.shape[1] * 16, policy, 256)
        x = ops._pad_to(x, vals.shape[1] * 16, 1)  # a bare pair's K
        kw = dict(policy=policy, k_tile=256, storage="nm", m_group=16)
        for impl in ("auto", "onepass", "twopass"):
            if impl == "onepass" and kp > ops.MAX_RESIDENT_K:
                with pytest.raises(ValueError):
                    pqs_dot(x, (vals, idx), sort_impl=impl, **kw)
                continue
            before = nm_spmm.nm_gather_sort_matmul.launches
            got = pqs_dot(x, (vals, idx), sort_impl=impl, **kw)
            assert torch.equal(got, want), (policy, k, impl)
            onepass = impl == "onepass" or (
                impl == "auto" and kp <= ops.MAX_RESIDENT_K)
            assert (nm_spmm.nm_gather_sort_matmul.launches
                    == before + 1) == onepass
        launched = (nm_spmm.nm_gather_sort_matmul.launches,
                    ss.nm_gather_tile_sums.launches,
                    ss.nm_gather_chunked_sort_matmul.launches,
                    sm.sort_matmul.launches)
        for impl in ("auto", "twopass"):
            before = _expand_launches()
            got = pqs_dot(x, (vals, idx), nm_impl="expand", sort_impl=impl,
                          **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (policy, k, impl)
            after = _expand_launches()
            route = _expand_route(policy, kp, impl)
            assert _launched(before, after) == route, (k, impl, after)
            assert all(after[n] == before[n] + 1 for n in route)
        assert (nm_spmm.nm_gather_sort_matmul.launches,
                ss.nm_gather_tile_sums.launches,
                ss.nm_gather_chunked_sort_matmul.launches,
                sm.sort_matmul.launches) == launched
        dense = nm_decompress(vals.to(torch.int32), idx, 16)[:, :k]
        assert torch.equal(dense.to(torch.int8), w)


@pytest.mark.parametrize("policy", ["sorted_tiled", "sorted"])
def test_engine_compressed_global_sort_kernels_and_plain_agree(card,
                                                               policy):
    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.core.qtensor import nm_compress_tree, quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              d_model=128, d_ff=256, num_heads=4,
                              head_dim=32)
    model = build_model(cfg)
    params = quantize_tree(model.init(0), bits=8, n_keep=8, m=16,
                           min_size=1 << 12, min_dim=16)
    sparse = nm_compress_tree(params, 8, 16)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 256, size=int(r.integers(3, 12))).astype(
        np.int32) for _ in range(4)]
    outs = {}
    for name, p, backend, impl in (("gather", sparse, "cuda", None),
                                   ("expand", sparse, "cuda", "expand"),
                                   ("plain", sparse, "torch", None),
                                   ("dense", params, "cuda", None)):
        before = (nm_spmm.nm_gather_sort_matmul.launches,
                  nm_spmm.nm_sort_matmul.launches)
        eng = ServingEngine(model, p, num_slots=3, max_len=64,
                            int_lin=IntegerLinConfig(policy=policy, k_tile=64,
                                                     backend=backend,
                                                     nm_impl=impl))
        reqs = [Request(uid=i, prompt=q, max_new_tokens=6)
                for i, q in enumerate(prompts)]
        eng.drain(reqs)
        outs[name] = [q.output for q in reqs]
        after = (nm_spmm.nm_gather_sort_matmul.launches,
                 nm_spmm.nm_sort_matmul.launches)
        if name == "gather":
            assert after[0] > before[0] and after[1] == before[1]
        if name == "expand":
            assert after[1] > before[1] and after[0] == before[0]
    assert outs["gather"] == outs["expand"] == outs["plain"] == outs["dense"]


# NM_SORT_CASES and a dense-as-sparse 16:16 case at the decode site shape
NM_EXPAND_CASES = NM_SORT_CASES + ((4, 1536, 256, 16, 16, 256),)


@pytest.mark.parametrize("policy", sm.SORT_POLICIES)
@pytest.mark.parametrize("acc_bits", [12, 16])
def test_nm_expand_sort_matmul_matches_plain_gather_and_dense(card, policy,
                                                              acc_bits):
    """The one-pass expand kernel equals its plain version, the gather
    kernel and the dense kernel on the decompressed weight over the same
    kp, given the unpadded x and slabs."""
    for i, case in enumerate(NM_EXPAND_CASES):
        x, w, vals, idx, m_group, k_tile = _nm_sort_case(
            case, 60 + i + acc_bits, card)
        kp = ops.padded_k(vals.shape[1] * m_group, policy, k_tile)
        for rounds in (1, 2):
            kw = dict(policy=policy, acc_bits=acc_bits, rounds=rounds,
                      k_tile=k_tile)
            got = nm_spmm.nm_sort_matmul(x, vals, idx, m_group=m_group, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, nm_spmm.nm_sort_matmul_ref(
                x, vals, idx, m_group=m_group, **kw)), (case, rounds)
            assert torch.equal(got, nm_spmm.nm_gather_sort_matmul(
                x, vals, idx, m_group=m_group, **kw)), (case, rounds)
            assert torch.equal(got, sm.sort_matmul(x, w, kp=kp, **kw)), (
                case, rounds)


def test_nm_expand_stream_kernels_match_plain_gather_and_dense(card):
    """Pass 1, pass 2 and the chunked expand kernels against their plain
    versions, the gather twins and the dense kernels on the decompressed
    weight; the two-pass route equals the one-pass kernel under both
    policies."""
    for i, case in enumerate(NM_EXPAND_CASES):
        x, w, vals, idx, m_group, k_tile = _nm_sort_case(case, 80 + i, card)
        g = vals.shape[1]
        kt = ops.padded_k(g * m_group, "sorted_tiled", k_tile)
        ks = ops.padded_k(g * m_group, "sorted", k_tile)
        nkw = dict(m_group=m_group)
        sums = ss.nm_tile_sums_matmul(x, vals, idx, k_tile=k_tile, **nkw)
        torch.cuda.synchronize()
        for want in (ss.nm_tile_sums_matmul_ref(x, vals, idx, k_tile=k_tile,
                                                **nkw),
                     ss.nm_gather_tile_sums(x, vals, idx, k_tile=k_tile,
                                            **nkw),
                     ss.tile_sums_matmul(x, w, k_tile=k_tile, kp=kt)):
            assert torch.equal(sums, want), case
        perm = pair_permutation(sums).to(torch.int32)
        for rounds in (1, 2):
            tk = dict(acc_bits=16, rounds=rounds, k_tile=k_tile)
            two = ss.nm_paired_accum_matmul(x, vals, idx, perm, **tk, **nkw)
            torch.cuda.synchronize()
            for want in (
                    ss.nm_paired_accum_matmul_ref(x, vals, idx, perm, **tk,
                                                  **nkw),
                    ss.nm_gather_paired_accum_matmul(x, vals, idx, perm,
                                                     **tk, **nkw),
                    ss.paired_accum_matmul(x, w, perm, kp=kt, **tk),
                    nm_spmm.nm_sort_matmul(x, vals, idx, policy="sorted_tiled",
                                           **tk, **nkw),
                    ss.nm_stream_sort_matmul(x, vals, idx,
                                             policy="sorted_tiled", **tk,
                                             **nkw)):
                assert torch.equal(two, want), (case, rounds)
            kw = dict(acc_bits=16, rounds=rounds)
            chunked = ss.nm_chunked_sort_matmul(x, vals, idx, **kw, **nkw)
            torch.cuda.synchronize()
            for want in (
                    ss.nm_chunked_sort_matmul_ref(x, vals, idx, **kw, **nkw),
                    ss.nm_gather_chunked_sort_matmul(x, vals, idx, **kw,
                                                     **nkw),
                    ss.chunked_sort_matmul(x, w, kp=ks, **kw),
                    nm_spmm.nm_sort_matmul(x, vals, idx, policy="sorted",
                                           **kw, **nkw)):
                assert torch.equal(chunked, want), (case, rounds)


@pytest.mark.parametrize("kernel", ["sort_matmul[sorted]",
                                    "sort_matmul[sorted_tiled]",
                                    "tile_sums", "paired_accum",
                                    "chunked_sort_matmul"])
def test_nm_expand_kernels_mask_without_host_padding(card, kernel):
    """Given x of K = 300 columns against 3:16 slabs of G = 19 groups (304
    columns), each expand kernel accumulates over the policy's padded K
    (320 under sorted_tiled at k_tile 64, 512 under sorted) and equals its
    plain version on x zero-padded to kp and the slabs zero-padded to
    kp / m groups, with no padded copy passed to the kernel."""
    m_group, k_tile = 16, 64
    x, _, vals, idx = _nm_w(5, 300, 70, 3, m_group, 10, card)
    policy = "sorted" if kernel in ("sort_matmul[sorted]",
                                    "chunked_sort_matmul") else "sorted_tiled"
    kp = ops.padded_k(vals.shape[1] * m_group, policy, k_tile)
    gp = kp // m_group - vals.shape[1]
    assert gp > 0
    px = ops._pad_to(x, kp, 1)
    pv = torch.nn.functional.pad(vals, (0, 0, 0, gp))
    pi = torch.nn.functional.pad(idx, (0, 0, 0, gp))
    kw = dict(m_group=m_group)
    for rounds in (1, 2):
        tk = dict(acc_bits=13, rounds=rounds, k_tile=k_tile, **kw)
        if kernel == "tile_sums":
            got = ss.nm_tile_sums_matmul(x, vals, idx, k_tile=k_tile, **kw)
            want = ss.nm_tile_sums_matmul_ref(px, pv, pi, k_tile=k_tile, **kw)
        elif kernel == "paired_accum":
            perm = pair_permutation(ss.nm_tile_sums_matmul_ref(
                px, pv, pi, k_tile=k_tile, **kw)).to(torch.int32)
            got = ss.nm_paired_accum_matmul(x, vals, idx, perm, **tk)
            want = ss.nm_paired_accum_matmul_ref(px, pv, pi, perm, **tk)
        elif kernel == "chunked_sort_matmul":
            got = ss.nm_chunked_sort_matmul(x, vals, idx, acc_bits=13,
                                            rounds=rounds, **kw)
            want = ss.nm_chunked_sort_matmul_ref(px, pv, pi, acc_bits=13,
                                                 rounds=rounds, **kw)
        else:
            got = nm_spmm.nm_sort_matmul(x, vals, idx, policy=policy, **tk)
            want = nm_spmm.nm_sort_matmul_ref(px, pv, pi, policy=policy,
                                              **tk)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kernel, rounds)


def test_nm_expand_kernels_keep_position_0_under_padded_slots(card):
    """Slot 0 of every group keeps a value at position 0 and the other
    slots are padding (value 0, index 0): the kernels' scatter-add leaves
    the kept value standing (a plain store of the padding would zero it),
    so each expand kernel equals the dense kernel on that weight."""
    m_group = 16
    x, _, vals, idx = _nm_w(4, 1536, 64, 8, m_group, 11, card)
    vals[:, :, 1:] = 0
    idx.zero_()
    w = torch.zeros((64, 1536), dtype=torch.int8, device=card)
    w[:, ::m_group] = vals[:, :, 0]
    assert bool((w != 0).any())
    kt = ops.padded_k(1536, "sorted_tiled", 256)
    perm = pair_permutation(ss.tile_sums_matmul(x, w, k_tile=256)).to(
        torch.int32)
    kw = dict(acc_bits=16, m_group=m_group)
    for got, want in (
            (nm_spmm.nm_sort_matmul(x, vals, idx, policy="sorted", **kw),
             sm.sort_matmul(x, w, policy="sorted", kp=2048)),
            (nm_spmm.nm_sort_matmul(x, vals, idx, policy="sorted_tiled", **kw),
             sm.sort_matmul(x, w, policy="sorted_tiled")),
            (ss.nm_tile_sums_matmul(x, vals, idx, m_group=m_group),
             ss.tile_sums_matmul(x, w, k_tile=256, kp=kt)),
            (ss.nm_paired_accum_matmul(x, vals, idx, perm, **kw),
             ss.paired_accum_matmul(x, w, perm)),
            (ss.nm_chunked_sort_matmul(x, vals, idx, **kw),
             ss.chunked_sort_matmul(x, w, kp=2048))):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_nm_expand_sort_kernels_count_launches_and_check_inputs(card):
    x, vals, idx = _nm(4, 256, 8, 2, 8, 0, card)
    perm = pair_permutation(ss.nm_tile_sums_matmul(
        x, vals, idx, m_group=8, k_tile=64)).to(torch.int32)
    kw = dict(m_group=8)
    calls = (
        (nm_spmm.nm_sort_matmul, lambda: nm_spmm.nm_sort_matmul(
            x, vals, idx, policy="sorted_tiled", k_tile=64, **kw)),
        (ss.nm_tile_sums_matmul, lambda: ss.nm_tile_sums_matmul(
            x, vals, idx, k_tile=64, **kw)),
        (ss.nm_paired_accum_matmul, lambda: ss.nm_paired_accum_matmul(
            x, vals, idx, perm, k_tile=64, **kw)),
        (ss.nm_chunked_sort_matmul, lambda: ss.nm_chunked_sort_matmul(
            x, vals, idx, **kw)),
    )
    for kernel, call in calls:
        before = kernel.launches
        call()
        assert kernel.launches == before + 1, kernel.__name__
    with pytest.raises(ValueError):  # x wider than the slabs' padded K
        nm_spmm.nm_sort_matmul(ops._pad_to(x, 257, 1), vals, idx, **kw)
    with pytest.raises(ValueError):  # k_tile % m_group != 0
        ss.nm_tile_sums_matmul(x, vals, idx, k_tile=4, **kw)
    with pytest.raises(ValueError):
        ss.nm_tile_sums_matmul(x, vals, idx.cpu(), k_tile=64, **kw)
    with pytest.raises(TypeError):
        ss.nm_chunked_sort_matmul(x, vals, idx.long(), **kw)
    with pytest.raises(ValueError):  # perm of the wrong shape
        ss.nm_paired_accum_matmul(x, vals, idx, perm[:, :, :2], k_tile=64,
                                  **kw)
    with pytest.raises(ValueError):
        ss.nm_paired_accum_matmul(x, vals, idx, perm.long(), k_tile=64,
                                  **kw)


@pytest.mark.parametrize("policy", sm.SORT_POLICIES)
def test_nm_auto_takes_expand_twins_on_card(card, policy):
    """``auto`` resolves to expand below GATHER_MIN_G groups (K = 112 at
    8:16: G = 7) and for dense-as-sparse 16:16 storage (one-pass at K =
    1536, two-pass at K = 8960), and pqs_dot(storage="nm") then launches
    the expand kernels of its route and no gather kernel, with the dense
    plain version's result."""
    for m, k, n, n_keep in ((4, 112, 40, 8), (4, 1536, 64, 16),
                            (3, 8960, 24, 16)):
        x, w, vals, idx = _nm_w(m, k, n, n_keep, 16, k + n_keep, card)
        g = vals.shape[1]
        assert ops.resolve_nm_impl(policy, g, n_keep, 16) == "expand"
        want = pqs_dot(x, w, policy=policy, k_tile=256, backend="torch")
        gather = (nm_spmm.nm_gather_sort_matmul.launches,
                  ss.nm_gather_tile_sums.launches,
                  ss.nm_gather_chunked_sort_matmul.launches)
        before = _expand_launches()
        got = pqs_dot(ops._pad_to(x, g * 16, 1), (vals, idx), storage="nm",
                      m_group=16, policy=policy, k_tile=256)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (policy, k, n_keep)
        kp = ops.padded_k(g * 16, policy, 256)
        assert _launched(before, _expand_launches()) == _expand_route(
            policy, kp, "auto"), (k, n_keep)
        assert (nm_spmm.nm_gather_sort_matmul.launches,
                ss.nm_gather_tile_sums.launches,
                ss.nm_gather_chunked_sort_matmul.launches) == gather


# (M, K, N) edge shapes of the wide kernels: decode and prefill M, ragged
# N and K (no multiple of 8, 16 or 32), K = 8960, and the quickstart's
# matmul
WIDE_SHAPES = ((1, 1536, 256), (4, 8960, 1536), (17, 300, 70),
               (128, 1536, 8960), (4, 33, 129), (128, 77, 5), (32, 512, 64))


def _extremes(x, w):
    """Rows of x and columns of w (K, N) at the int8 corners."""
    x[0], w[:, 0] = -128, -128
    if x.shape[0] > 1:
        x[-1] = 127
    if w.shape[1] > 1:
        w[:, -1] = 127
    return x, w


@pytest.mark.parametrize("m,k,n", WIDE_SHAPES)
def test_quant_matmul_matches_plain_and_wide_policy(card, m, k, n):
    """Row 3 (``quant_matmul``, w (K, N)) bit-exact against its plain
    version and against ``seq_policy_matmul`` under ``wide`` on wᵀ, with
    the int8 extremes at a corner; one launch each call."""
    x, wt = _xw(m, k, n, m + k + n, card)
    x, w = _extremes(x, wt.t().contiguous())
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(x, w)
    want = qm.quant_matmul_ref(x, w)
    wide = sm.seq_policy_matmul(x, w.t().contiguous(), policy="wide")
    torch.cuda.synchronize()
    assert qm.quant_matmul.launches == before + 1
    assert torch.equal(got, want) and torch.equal(got, wide), (m, k, n)
    assert int(got[0, 0]) == 128 * 128 * k


@pytest.mark.parametrize("n_keep,m_group", [(8, 16), (4, 16), (2, 8),
                                            (16, 16)])
def test_nm_spmm_matches_plain_and_quant_matmul(card, n_keep, m_group):
    """Row 4 (``nm_spmm``) bit-exact against its plain version and row 3
    on the decompressed weight, at the edge shapes; then with padded
    slots (value 0, index 0) behind a kept value at position 0 of each
    group, which the in-kernel scatter-add must keep."""
    for m, k, n in WIDE_SHAPES:
        x, w, vals, idx = _nm_w(m, k, n, n_keep, m_group, m + k + n_keep,
                                card)
        before = nm_spmm.nm_spmm.launches
        got = nm_spmm.nm_spmm(x, vals, idx, m_group=m_group)
        want = nm_spmm.nm_spmm_ref(x, vals, idx, m_group=m_group)
        dense = qm.quant_matmul(x, w.t().contiguous())
        torch.cuda.synchronize()
        assert nm_spmm.nm_spmm.launches == before + 1
        assert torch.equal(got, want) and torch.equal(got, dense), (m, k, n)
    vals[:, :, 1:] = 0
    idx.zero_()
    vals[:, :, 0] = -128
    dense = nm_decompress(vals, idx, m_group)[:, :k]
    got = nm_spmm.nm_spmm(x, vals, idx, m_group=m_group)
    torch.cuda.synchronize()
    assert torch.equal(got, qm.quant_matmul(x, dense.t().contiguous()))
    assert bool((dense[:, 0] == -128).all())


def test_wide_kernels_check_inputs(card):
    x = torch.zeros((3, 64), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        qm.quant_matmul(x, torch.zeros((64, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x, torch.zeros((5, 64), dtype=torch.int8,
                                       device=card).t())
    with pytest.raises(ValueError, match="int8 values"):
        qm.quant_matmul(x, torch.full((64, 5), 300, dtype=torch.int32,
                                      device=card))
    assert qm.quant_matmul(x[:, :0], torch.zeros(
        (0, 5), dtype=torch.int8, device=card)).abs().sum() == 0


def test_quickstart_on_card_matches_cpu(card, capsys):
    """repro_torch.quickstart on the card returns and prints what it does
    on the CPU (apart from the device label), through the row 3, row 4
    and seq_policy_matmul kernels, whose results equal the plain
    versions' on the same inputs element by element."""
    from repro_torch import quickstart
    counts = (qm.quant_matmul.launches, nm_spmm.nm_spmm.launches,
              sm.seq_policy_matmul.launches)
    on_card, card_t = quickstart.run()
    card_out = capsys.readouterr().out.replace("(kernel, cuda)",
                                               "(kernel, cpu)")
    assert all(c > b for c, b in zip((qm.quant_matmul.launches,
                                      nm_spmm.nm_spmm.launches,
                                      sm.seq_policy_matmul.launches),
                                     counts))
    on_cpu, cpu_t = quickstart.run(device="cpu")
    assert on_card == on_cpu
    assert card_out == capsys.readouterr().out
    assert set(card_t) == set(cpu_t)
    for key, want in cpu_t.items():
        assert card_t[key].is_cuda and torch.equal(card_t[key].cpu(),
                                                   want), key


@pytest.mark.parametrize("kernel", ["nm_spmm", "nm_sort_matmul",
                                    "nm_tile_sums_matmul",
                                    "nm_seq_policy_matmul"])
def test_expand_kernels_drop_out_of_group_indices(card, kernel):
    """A slot whose index lies outside [0, m_group) adds nothing in the
    kernels that rebuild slabs in shared memory, as the JAX package's
    one-hot expansion drops it: the result is the plain version's on the
    slabs with those slots' values set to 0. Row 10's pass 1 drops it on
    the body it shares with the gather twin, at a few-rows and a
    many-rows M (where the gather twin reads x at the index instead).
    Row 5's expand kernel drops it in its scatter, under every policy."""
    m_group = 16
    for m in ((4, 17) if kernel == "nm_tile_sums_matmul" else (17,)):
        x, _, vals, idx = _nm_w(m, 300, 70, 4, m_group, 33, card)
        bad, dropped = idx.clone(), vals.clone()
        for j, (sl, i) in enumerate(((slice(0, None, 3), m_group),
                                     (slice(1, None, 3), -1),
                                     (slice(2, None, 3), 1 << 20))):
            bad[:, sl, j + 1] = i
            dropped[:, sl, j + 1] = 0
        assert bool((vals != dropped).any())
        if kernel == "nm_spmm":
            got = nm_spmm.nm_spmm(x, vals, bad, m_group=m_group)
            want = nm_spmm.nm_spmm_ref(x, dropped, idx, m_group=m_group)
        elif kernel == "nm_sort_matmul":
            kw = dict(m_group=m_group, policy="sorted_tiled", acc_bits=16,
                      k_tile=64)
            got = nm_spmm.nm_sort_matmul(x, vals, bad, **kw)
            want = nm_spmm.nm_sort_matmul_ref(x, dropped, idx, **kw)
        elif kernel == "nm_seq_policy_matmul":
            for policy in sm.SEQ_POLICIES[:-1]:
                kw = dict(m_group=m_group, policy=policy, acc_bits=12,
                          k_tile=64)
                got = nm_spmm.nm_seq_policy_matmul(x, vals, bad, **kw)
                want = nm_spmm.nm_seq_policy_matmul_ref(x, dropped, idx,
                                                        **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), policy
            kw = dict(m_group=m_group, policy="sorted_tiled_seq",
                      acc_bits=12, k_tile=64)
            got = nm_spmm.nm_seq_policy_matmul(x, vals, bad, **kw)
            want = nm_spmm.nm_seq_policy_matmul_ref(x, dropped, idx, **kw)
        else:
            kw = dict(m_group=m_group, k_tile=64)
            got = ss.nm_tile_sums_matmul(x, vals, bad, **kw)
            want = ss.nm_tile_sums_matmul_ref(x, dropped, idx, **kw)
            assert ss.nm_expand_tile_sums_body(m, 64) == (
                "few_rows" if m <= 16 else "many_rows")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (kernel, m)


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k_tile", [2048, 4096])
def test_nm_tile_sums_matmul_long_tiles(card, m, k_tile):
    """Row 10 above the 1024 positions its shared body stages runs its
    one-warp body (``nm_expand_tile_sums_body``), equal to the plain
    version, to row 9 on the decompressed weight and, summed pairwise, to
    itself at half the tile; canonical and non-canonical slabs."""
    x, w, vals, idx = _nm_w(m, 8192 - 9, 40, 8, 16, k_tile + m, card)
    assert ss.nm_expand_tile_sums_body(m, k_tile) == "warp"
    kw = dict(m_group=16, k_tile=k_tile)
    got = ss.nm_tile_sums_matmul(x, vals, idx, **kw)
    half = ss.nm_tile_sums_matmul(x, vals, idx, m_group=16,
                                  k_tile=k_tile // 2)
    kp = ops.padded_k(vals.shape[1] * 16, "sorted_tiled", k_tile)
    torch.cuda.synchronize()
    assert torch.equal(got, ss.nm_tile_sums_matmul_ref(x, vals, idx, **kw))
    assert torch.equal(got, ss.tile_sums_matmul(x, w, k_tile=k_tile, kp=kp))
    assert torch.equal(got, half.reshape(m, 40, -1, 2).sum(-1,
                                                           dtype=torch.int32))
    nv, ni = _non_canonical(vals, idx)
    assert torch.equal(ss.nm_tile_sums_matmul(x, nv, ni, **kw),
                       ss.nm_tile_sums_matmul_ref(x, nv, ni, **kw))


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("m,k,n", WIDE_SHAPES + ((200, 272, 144),
                                                 (16, 1536, 256)))
def test_quant_matmul_bodies(card, m, k, n, offset):
    """Row 3 on each body it can run, bit-exact against its plain version:
    the TMA-fed body where operands are 16-byte aligned and N, K
    multiples of 16 (``quant_matmul_body``), the KnRows body everywhere;
    the default call runs the body the choice function names; the TMA
    body on operands it cannot take is refused."""
    x, wt = _xw(m, k, n, m + k + n + offset, card)
    x, w = _extremes(x, wt.t().contiguous())
    x, w = _offset(x, offset), _offset(w, offset)
    want = qm.quant_matmul_ref(x, w)
    body = qm.quant_matmul_body(n, k, x.data_ptr(), w.data_ptr())
    assert body == ("tma" if offset == 0 and n % 16 == 0 and k % 16 == 0
                    else "kn_rows")
    before = dict(qm.quant_matmul.body_launches)
    got = qm.quant_matmul(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (m, k, n, offset, body)
    assert {b: qm.quant_matmul.body_launches[b] - before[b]
            for b in qm.BODIES} == {b: int(b == body) for b in qm.BODIES}
    assert torch.equal(qm.quant_matmul(x, w, body="kn_rows"), want)
    if body == "tma":
        assert torch.equal(qm.quant_matmul(x, w, body="tma"), want)
    else:
        with pytest.raises(ValueError, match="does not take"):
            qm.quant_matmul(x, w, body="tma")


def test_quant_matmul_int32_wrap(card):
    """Both bodies of row 3 wrap a sum past 2^31 as an int32 dot_general
    does (K = 131088, all -128), the TMA body over K split among a
    cluster's blocks."""
    k = 131088
    x = torch.full((3, k), -128, dtype=torch.int8, device=card)
    w = torch.full((k, 32), -128, dtype=torch.int8, device=card)
    want = (128 * 128 * k + (1 << 31)) % (1 << 32) - (1 << 31)
    for body in qm.BODIES:
        got = qm.quant_matmul(x, w, body=body)
        torch.cuda.synchronize()
        assert bool((got == want).all()), body


def _offset(t, offset):
    """A contiguous copy of int8 ``t`` whose data starts ``offset`` bytes
    past the start of its allocation (not 16- or 4-byte aligned for an
    odd offset)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("m,k,n", WIDE_SHAPES)
def test_wide_policy_copy_paths(card, m, k, n, offset):
    """Row 1 under ``wide`` (the tensor-core mainloop) bit-exact against
    its plain version and row 3 on the transposed weight, through each
    copy width of its ring: 16-byte copies (K a multiple of 16, aligned
    operands), 4-byte ones (K = 300, or an operand 4 bytes off) and byte
    loads (odd K, or an operand 1 byte off); the int8 extremes at a
    corner."""
    x, w = _xw(m, k, n, m + k + n + offset, card)
    x[0], w[0] = -128, -128
    if m > 1:
        x[-1] = 127
    if n > 1:
        w[-1] = 127
    x, w = _offset(x, offset), _offset(w, 2 * offset)
    got = sm.seq_policy_matmul(x, w, policy="wide")
    want = sm.seq_policy_matmul_ref(x, w, policy="wide")
    row3 = qm.quant_matmul(x, w.t().contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, row3), (m, k, n)
    assert int(got[0, 0]) == 128 * 128 * k


@pytest.mark.parametrize("m", [1, 3, 4, 5, 7])
def test_sorted_tiled_seq_packed_rows(card, m):
    """Row 1 under ``sorted_tiled_seq`` (rows in packed int16x2 pairs; an
    odd M leaves the last partner half zero) bit-exact against its plain
    version at k_tile 1 to 1024, rounds 1 to 3 and acc_bits 2, 16 and 30,
    K not a multiple of a chunk, with all -128 and all 127 rows of x
    against all -128 and all 127 rows of w at the corners; and clip and
    wrap at the same M."""
    x, w = _xw(m, 1100, 37, 17 * m, card)
    x[0], w[0] = -128, -128
    x[-1], w[-1] = 127, 127
    if m > 2:
        x[1] = -128
    for k_tile in (1, 8, 32, 256, 1024):
        for rounds in (1, 2, 3):
            for acc_bits in (2, 16, 30):
                kw = dict(policy="sorted_tiled_seq", acc_bits=acc_bits,
                          rounds=rounds, k_tile=k_tile)
                got = sm.seq_policy_matmul(x, w, **kw)
                want = sm.seq_policy_matmul_ref(x, w, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), kw
    for policy in ("clip", "wrap"):
        for acc_bits in (2, 16, 30):
            kw = dict(policy=policy, acc_bits=acc_bits)
            assert torch.equal(sm.seq_policy_matmul(x, w, **kw),
                               sm.seq_policy_matmul_ref(x, w, **kw)), kw


@pytest.mark.parametrize("n_keep,m_group", [(4, 16), (2, 8), (3, 12),
                                            (8, 32)])
def test_nm_spmm_non_canonical_slabs(card, n_keep, m_group):
    """Row 4 on slabs that are not canonical but on which it and its
    plain version agree: slots whose index is >= m_group or negative
    (dropped by both, as the JAX package's one-hot expansion drops them)
    and pairs of nonzero slots at one position whose sum stays inside
    int8 (added, not overwritten). (3, 12) and (8, 32) take the loader
    for groups that do not divide 16."""
    x, _, vals, idx = _nm_w(17, 300, 70, n_keep, m_group, n_keep + m_group,
                            card)
    vals, idx = vals.clone(), idx.clone()
    # slot 1 joins slot 0's position, the two values' sum inside int8
    vals[:, 2::3, :2] = (vals[:, 2::3, :2].to(torch.int32) // 3).to(
        torch.int8)
    idx[:, 2::3, 1] = idx[:, 2::3, 0]
    bad, kept = idx.clone(), vals.clone()
    bad[:, 0::3, -1], kept[:, 0::3, -1] = m_group, 0
    bad[:, 1::3, -1], kept[:, 1::3, -1] = -1, 0
    assert bool((kept != vals).any())
    got = nm_spmm.nm_spmm(x, vals, bad, m_group=m_group)
    want = nm_spmm.nm_spmm_ref(x, kept, idx, m_group=m_group)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # and pairs whose sum leaves int8 (127 + 127, -128 + -128): the
    # position's weight is their int32 sum, which the kernel's exact route
    # keeps, where a byte would wrap it
    past = vals.clone()
    past[:, 2::3, :2] = 127
    past[:, 5::6, :2] = -128
    got = nm_spmm.nm_spmm(x, past, idx, m_group=m_group)
    want = nm_spmm.nm_spmm_ref(x, past, idx, m_group=m_group)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [5, 128])
@pytest.mark.parametrize("k_tile", [1, 4, 16, 32, 64, 512, 1024])
def test_tile_sums_bodies_every_k_tile(card, k_tile, m):
    """Row 9's two bodies (the int8 mainloop with its per-tile epilogue at
    k_tile >= 64, the small-tile body below) against the plain version, K
    not a multiple of a 64-byte slab, at a decode and a prefill M, also
    with a tile past K (kp + k_tile: its sums are 0), the int8 extremes in
    row 0."""
    x, w = _xw(m, 3072 - 7, 40, 3 * k_tile + m, card)
    x[0], w[0] = -128, -128
    kp = ops.padded_k(x.shape[1], "sorted_tiled", k_tile)
    for kpx in (kp, kp + k_tile):
        got = ss.tile_sums_matmul(x, w, k_tile=k_tile, kp=kpx)
        want = ss.tile_sums_matmul_ref(x, w, k_tile=k_tile, kp=kpx)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k_tile, m, kpx,
                                        ss.tile_sums_body(k_tile, 3065))


def _non_canonical(vals, idx):
    """Each group's slots reversed (unsorted indices), and in every third
    group slot 0 at the last slot's position (a duplicate)."""
    vals, idx = vals.flip(-1).contiguous(), idx.flip(-1).contiguous()
    idx[:, 1::3, 0] = idx[:, 1::3, -1]
    return vals, idx


@pytest.mark.parametrize("m", [1, 4, 5, 128])
@pytest.mark.parametrize("n_keep,m_group", [(8, 16), (2, 4), (3, 16)])
def test_nm_gather_tile_sums_bodies(card, m, n_keep, m_group):
    """Row 11's two bodies (lanes over a tile's slots up to 16 rows of x,
    over rows above) against the plain version and row 9 on the
    decompressed weight at k_tile 16 to 1024, K = 1001 (groups past G and
    positions past K masked); on non-canonical slabs against the plain
    version; and with an index outside its group but below K, which reads
    x where it points, as the plain version does."""
    x, w, vals, idx = _nm_w(m, 1001, 70, n_keep, m_group, m + n_keep, card)
    odd = idx.clone()
    odd[:, 2, 0] = m_group + 1
    nv, ni = _non_canonical(vals, idx)
    for k_tile in (16, 64, 256, 1024):
        kw = dict(m_group=m_group, k_tile=k_tile)
        kt = ops.padded_k(vals.shape[1] * m_group, "sorted_tiled", k_tile)
        got = ss.nm_gather_tile_sums(x, vals, idx, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ss.nm_gather_tile_sums_ref(x, vals, idx,
                                                           **kw)), k_tile
        assert torch.equal(got, ss.tile_sums_matmul(x, w, k_tile=k_tile,
                                                    kp=kt)), k_tile
        for v, i in ((nv, ni), (vals, odd)):
            assert torch.equal(ss.nm_gather_tile_sums(x, v, i, **kw),
                               ss.nm_gather_tile_sums_ref(x, v, i, **kw)), (
                k_tile, ss.nm_tile_sums_body(m))


def test_pass1_wrappers_refuse_mixed_devices(card):
    """Rows 9 and 11 launch only on operands on one CUDA device: a CPU
    operand beside CUDA ones is refused, as is a gather tile the card
    kernel does not stage (k_tile above 1024)."""
    x, w = _xw(4, 2048, 8, 0, card)
    for a, b in ((x, w.cpu()), (x.cpu(), w)):
        with pytest.raises(ValueError):
            ss.tile_sums_matmul(a, b, k_tile=64)
    x, vals, idx = _nm(4, 2048, 8, 8, 16, 0, card)
    for args in ((x.cpu(), vals, idx), (x, vals.cpu(), idx),
                 (x, vals, idx.cpu())):
        with pytest.raises(ValueError):
            ss.nm_gather_tile_sums(*args, m_group=16, k_tile=64)
    with pytest.raises(NotImplementedError):
        ss.nm_gather_tile_sums(x, vals, idx, m_group=16, k_tile=2048)


# kp regimes of the register-resident `sorted` body (csrc/pqs_accum.cuh
# sorted_dot): padded to 64 keys (32), one warp (64, 2048), the first
# exchange across warps (4096), the main path's w_out (16384) and 16 warps
# of 64 keys a lane (65536)
SORTED_KP = (32, 64, 2048, 4096, 16384, 65536)


def _sorted_rows(m, k, n, seed, card):
    """Seeded x (m, k) and w (n, k) whose outputs probe the body: (0, 0)
    all keys -16256 (x -128, w 127), (0, 1) all 16384 (x -128, w -128),
    row 1 of x all zero, (2, 2) keys of one sign (positive) and (2, 3) of
    the other."""
    x, w = _xw(m, k, n, seed, card)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x[0], w[0], w[1], x[1] = -128, 127, -128, 0
    x[2] = torch.randint(1, 128, (k,), generator=g).to(card, torch.int8)
    w[2] = torch.randint(1, 128, (k,), generator=g).to(card, torch.int8)
    w[3] = torch.randint(-128, 0, (k,), generator=g).to(card, torch.int8)
    return x, w


@pytest.mark.parametrize("kp", SORTED_KP)
@pytest.mark.parametrize("loader", ["dense", "gather", "expand"])
def test_sorted_body_regimes(card, loader, kp):
    """Rows 2, 15 (dense), 8, 17 (gather) and 7, 16 (expand) under
    ``sorted`` against their plain versions in every regime of the body's
    shape, at an odd M, rounds 1 to 3 and acc_bits 2, 16 and 30, with keys
    at -16256 and 16384, outputs of one sign only and an all-zero row of
    x; K = kp and K short of it (the tail masked in the kernel). The
    gather twin's kept keys (8:16 slabs of 2 K positions) number kp."""
    for k in sorted({kp, max(1, kp - kp // 4 - 3)}):
        if loader == "dense":
            x, w = _sorted_rows(3, k, 5, kp + k, card)
            args, kern, ref = (x, w), sm.sort_matmul, sm.sort_matmul_ref
            extra = dict(kp=kp)
        else:
            x, w = _sorted_rows(3, 2 * k if loader == "gather" else k, 5,
                                kp + k, card)
            _, vals, idx = _prune(w, 8, 16)
            args, extra = (x, vals, idx), dict(m_group=16)
            kern = (nm_spmm.nm_gather_sort_matmul if loader == "gather"
                    else nm_spmm.nm_sort_matmul)
            ref = (nm_spmm.nm_gather_sort_matmul_ref if loader == "gather"
                   else nm_spmm.nm_sort_matmul_ref)
        for rounds in (1, 2, 3):
            for acc_bits in (2, 16, 30):
                kw = dict(policy="sorted", acc_bits=acc_bits, rounds=rounds,
                          **extra)
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, ref(*args, **kw)), (k, rounds,
                                                            acc_bits)


@pytest.mark.parametrize("tiles", [1, 3, 7])
def test_paired_tiles_packed(card, tiles):
    """Rows 2, 7 and 8 under ``sorted_tiled`` and the pass-2 rows 12, 13
    and 14, whose pair slots sort their two tiles as the halves of packed
    int16x2 keys (an odd last tile against a zero half), against their
    plain versions: a single tile and odd tile counts, k_tile 16 and 256,
    rounds 1 to 3, acc_bits 2, 16 and 30, the int8 extremes in row 0."""
    for k_tile in (16, 256):
        k = tiles * k_tile
        x, w = _xw(5, k, 37, tiles + k_tile, card)
        x, w = _tied(x, w, k_tile)
        x[0, : k // 2], w[0, : k // 3] = -128, -128
        w, vals, idx = _prune(w, 8, 16)
        nk = dict(m_group=16)
        perm = pair_permutation(ss.tile_sums_matmul(x, w, k_tile=k_tile)).to(
            torch.int32)
        for rounds in (1, 2, 3):
            for acc_bits in (2, 16, 30):
                kw = dict(acc_bits=acc_bits, rounds=rounds, k_tile=k_tile)
                tk = dict(kw, policy="sorted_tiled")
                for got, want in (
                        (sm.sort_matmul(x, w, **tk),
                         sm.sort_matmul_ref(x, w, **tk)),
                        (ss.paired_accum_matmul(x, w, perm, **kw),
                         ss.paired_accum_matmul_ref(x, w, perm, **kw)),
                        (nm_spmm.nm_gather_sort_matmul(x, vals, idx, **tk,
                                                       **nk),
                         nm_spmm.nm_gather_sort_matmul_ref(x, vals, idx,
                                                           **tk, **nk)),
                        (nm_spmm.nm_sort_matmul(x, vals, idx, **tk, **nk),
                         nm_spmm.nm_sort_matmul_ref(x, vals, idx, **tk,
                                                    **nk)),
                        (ss.nm_gather_paired_accum_matmul(x, vals, idx, perm,
                                                          **kw, **nk),
                         ss.nm_gather_paired_accum_matmul_ref(
                             x, vals, idx, perm, **kw, **nk)),
                        (ss.nm_paired_accum_matmul(x, vals, idx, perm, **kw,
                                                   **nk),
                         ss.nm_paired_accum_matmul_ref(x, vals, idx, perm,
                                                       **kw, **nk))):
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (k_tile, rounds, acc_bits)


def test_expand_tiled_weights_past_int8(card):
    """An expanded row whose slots name one position several times holds
    their sum, past int8, so its products leave the int16 keys' range:
    rows 7 (``sorted_tiled``) and 13 then sort them as int32 and still
    equal their plain versions (the int32 scatter-add of the slots)."""
    m_group, k_tile = 16, 256
    x, _, vals, idx = _nm_w(5, 1024, 21, 4, m_group, 5, card, k_tile)
    x[:, ::m_group] = 127
    vals[::2, 1::2] = 127  # every slot of those groups at position 0: 508
    idx[::2, 1::2] = 0
    nk = dict(m_group=m_group)
    perm = pair_permutation(ss.nm_tile_sums_matmul(
        x, vals, idx, k_tile=k_tile, **nk)).to(torch.int32)
    for rounds in (1, 2):
        for acc_bits in (16, 30):
            kw = dict(acc_bits=acc_bits, rounds=rounds, k_tile=k_tile, **nk)
            tk = dict(kw, policy="sorted_tiled")
            assert torch.equal(nm_spmm.nm_sort_matmul(x, vals, idx, **tk),
                               nm_spmm.nm_sort_matmul_ref(x, vals, idx,
                                                          **tk))
            assert torch.equal(
                ss.nm_paired_accum_matmul(x, vals, idx, perm, **kw),
                ss.nm_paired_accum_matmul_ref(x, vals, idx, perm, **kw))


# the expand `sorted` kernel's shapes (pqs_accum.cuh dispatch_sorted): kp
# 16 (padded to 64 keys) and 64 to 2048 on one warp, the radix regime from
# 4096 to 32768, the register network of 16 warps at 65536
EXPAND_SORTED_KP = (16, 64, 2048, 4096, 16384, 32768, 65536)


@pytest.mark.parametrize("kp", EXPAND_SORTED_KP)
def test_expand_sorted_weights_past_int8(card, kp):
    """Rows 7 (``nm_sort_matmul`` under ``sorted``) and 16
    (``nm_chunked_sort_matmul``) on slabs whose slots name one position
    several times: the expanded weight is their sum, past int8, and its
    products past int16, which the kernel sorts as int32 keys in its
    device pool (the other rows stay on the int16 bodies), equal to the
    plain version at every shape of the kernel, rounds 0 to 3 (with none,
    the route adds in natural order); and the smallest case, M =
    N = 1, K = 16, three 3:16 slots at position 0 of value 127 and x =
    127, which int16 keys wrapped to -17149."""
    m_group, n_keep = 16, 3
    x, _, vals, idx = _nm_w(3, kp, 5, n_keep, m_group, kp + 7, card)
    vals[1::2, ::2] = 127  # every slot of every other group at position 0
    idx[1::2, ::2] = 0
    x[:, ::2 * m_group] = 127
    x[2, ::4 * m_group] = -128
    nk = dict(m_group=m_group)
    for rounds, acc_bits in ((1, 30), (2, 16), (3, 2), (0, 16)):
        kw = dict(acc_bits=acc_bits, rounds=rounds, **nk)
        got = nm_spmm.nm_sort_matmul(x, vals, idx, policy="sorted", **kw)
        want = nm_spmm.nm_sort_matmul_ref(x, vals, idx, policy="sorted",
                                          **kw)
        chunked = ss.nm_chunked_sort_matmul(x, vals, idx, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (rounds, acc_bits)
        assert torch.equal(chunked, want), (rounds, acc_bits)
    one = torch.zeros((1, 16), dtype=torch.int8, device=card)
    one[0, 0] = 127
    v3 = torch.full((1, 1, 3), 127, dtype=torch.int8, device=card)
    i3 = torch.zeros((1, 1, 3), dtype=torch.int32, device=card)
    got = nm_spmm.nm_sort_matmul(one, v3, i3, m_group=16, policy="sorted",
                                 acc_bits=30)
    assert got.tolist() == [[48387]]


def _keys_rows(k, card, seed):
    """x (4, k) and w (6, k) whose outputs are the key patterns of the
    `sorted` body: row 0 of x all zero (every key 0), row 1 all 3 and row
    2 all -128, row 3 random; w rows 5 and -7 everywhere (all keys equal),
    127 / -128 alternating (with x -128: keys -16256 and 16384), one
    nonzero weight, -1 / 0 / 1 (heavy ties), random. Every odd position
    of w is zero, so its 8:16 slabs keep the even ones."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.empty((4, k), dtype=torch.int8)
    x[0], x[1], x[2] = 0, 3, -128
    x[3] = torch.randint(-128, 128, (k,), generator=g)
    w = torch.zeros((6, k), dtype=torch.int8)
    w[0], w[1] = 5, -7
    w[2, 0::4], w[2, 2::4] = 127, -128
    w[3, (k // 3) & ~1] = 100
    w[4] = torch.randint(-1, 2, (k,), generator=g)
    w[5] = torch.randint(-128, 128, (k,), generator=g)
    w[:, 1::2] = 0
    return x.to(card), w.to(card)


@pytest.mark.parametrize("kp", [4096, 8192, 16384, 32768, 65536])
def test_sorted_long_k_key_patterns(card, kp):
    """Rows 15 (``chunked_sort_matmul``), 16 (``nm_chunked_sort_matmul``)
    and 17 (``nm_gather_chunked_sort_matmul``, whose kept keys number kp:
    slabs of 2 kp positions) at every kp of the radix regime and at 65536,
    on keys all zero, all equal, alternating -16256 / 16384, one nonzero
    key and heavy ties, K = kp and K short of it, rounds 0 to 3, against
    their plain versions."""
    nk = dict(m_group=16)
    for k in (kp, kp - kp // 4 - 3):
        x, w = _keys_rows(k, card, kp + k)
        _, vals, idx = _prune(w, 8, 16)
        xg, wg = _keys_rows(2 * k, card, kp + k + 1)
        _, gvals, gidx = _prune(wg, 8, 16)
        for rounds, acc_bits in ((1, 16), (2, 2), (3, 30), (0, 16)):
            kw = dict(acc_bits=acc_bits, rounds=rounds)
            for got, want in (
                    (ss.chunked_sort_matmul(x, w, kp=kp, **kw),
                     ss.chunked_sort_matmul_ref(x, w, kp=kp, **kw)),
                    (ss.nm_chunked_sort_matmul(x, vals, idx, **kw, **nk),
                     ss.nm_chunked_sort_matmul_ref(x, vals, idx, **kw,
                                                   **nk)),
                    (ss.nm_gather_chunked_sort_matmul(xg, gvals, gidx, **kw,
                                                      **nk),
                     ss.nm_gather_chunked_sort_matmul_ref(xg, gvals, gidx,
                                                          **kw, **nk))):
                torch.cuda.synchronize()
                assert torch.equal(got, want), (k, rounds, acc_bits)


# (M, N, K, n_keep, m_group, k_tile) reaching each split of row 6's tiles
# over warps (1, 2, 4 and 8 warps an output), several windows of staged x
# (K = 65536), ragged G, n_keep = m, odd M, tiles of 16 to 1024
GATHER_SPLIT_CASES = (
    (1, 1, 16, 8, 16, 16), (4, 70, 300, 3, 16, 64),
    (5, 256, 1536, 8, 16, 256), (17, 70, 4000, 16, 16, 1024),
    (4, 1536, 8960, 8, 16, 256), (8, 1536, 1536, 8, 16, 256),
    (12, 1536, 1536, 8, 16, 256), (128, 1536, 1536, 8, 16, 256),
    (1, 70, 65536, 4, 16, 512), (5, 3, 65536, 2, 4, 16),
)


@pytest.mark.parametrize("case", GATHER_SPLIT_CASES, ids=str)
def test_nm_gather_seq_packed_split(card, case):
    """Row 6's packed, K-split body (rows in packed pairs, an output's
    tiles split over warps, x staged a window at a time) against its plain
    version under every policy (``sorted_tiled_seq`` at rounds 0 to 3 and
    acc_bits 2, 16 and 30) and, on canonical slabs, against the dense
    kernel on the decompressed weight; on non-canonical slabs (unsorted
    and duplicate indices) against the plain version."""
    m, n, k, n_keep, m_group, k_tile = case
    x, w, vals, idx = _nm_w(m, k, n, n_keep, m_group, m + n + k, card)
    nv, ni = _non_canonical(vals, idx)
    runs = [("sorted_tiled_seq", r, b) for r, b in ((0, 16), (1, 16),
                                                    (2, 2), (3, 30))]
    runs += [(p, 1, 16) for p in ("wide", "clip", "wrap")]
    for policy, rounds, acc_bits in runs:
        kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
                  rounds=rounds, k_tile=k_tile)
        got = nm_spmm.nm_gather_seq_policy_matmul(x, vals, idx, **kw)
        want = nm_spmm.nm_gather_seq_policy_matmul_ref(x, vals, idx, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (policy, rounds, acc_bits)
        if policy == "sorted_tiled_seq" and rounds == 1:
            dense = sm.seq_policy_matmul(
                x, w, policy=policy, acc_bits=acc_bits, rounds=rounds,
                k_tile=k_tile)
            assert torch.equal(got, dense)
            got = nm_spmm.nm_gather_seq_policy_matmul(x, nv, ni, **kw)
            assert torch.equal(got, nm_spmm.nm_gather_seq_policy_matmul_ref(
                x, nv, ni, **kw))


def _negative_slabs(vals, idx, m_group, width):
    """Slabs with positions before x's row: in every fifth group slot 0 at
    position -1 - (g % 7) (an index below -g * m_group: it wraps from the
    end of x's row of ``width``), and in every seventh slot 1 below
    -width (a zero product)."""
    vals, idx = vals.clone(), idx.clone()
    g = torch.arange(idx.shape[1], device=idx.device, dtype=torch.int32)
    idx[:, ::5, 0] = (-g * m_group - 1 - g % 7)[::5]
    idx[:, ::7, 1] = (-g * m_group - width - 3)[::7]
    vals[:, ::5, 0] = vals[:, ::5, 0].clamp(min=1)
    return vals, idx


# (kernel, M, N, K): the gather kernels near the shapes of the main path's
# sites (row 17's `sorted` past 2048 kept keys, as at w_out; K = kp, where
# a wrapped position reads x, and K short of it)
GATHER_FAULT_CASES = (("seq", 5, 37, 1000), ("seq", 5, 37, 1536),
                      ("sort", 5, 37, 1536), ("sort", 5, 37, 2048),
                      ("sort", 3, 9, 1000), ("sums", 5, 37, 1536),
                      ("pass2", 5, 37, 1536), ("chunked", 3, 9, 8192),
                      ("chunked", 3, 9, 8960))


@pytest.mark.parametrize("case", GATHER_FAULT_CASES, ids=str)
def test_gather_kernels_negative_positions(card, case):
    """Rows 6, 8, 11, 14 and 17 on slabs whose gathered positions lie
    before x's row (``_negative_slabs``) against their plain versions: a
    position in [-W, 0) reads x at position + W (W the padded K, G * m for
    row 6), one below -W is a zero product, and no kernel reads outside x
    (before the repair rows 8, 14 and 17 read the bytes before x's row,
    rows 6 and 11 a zero)."""
    kernel, m, n, k = case
    x, _, vals, idx = _nm_w(m, k, n, 8, 16, m + n + k, card)
    g = vals.shape[1]
    nk = dict(m_group=16)
    if kernel == "seq":
        nv, ni = _negative_slabs(vals, idx, 16, g * 16)
        for policy in sm.SEQ_POLICIES:
            kw = dict(policy=policy, acc_bits=16, rounds=1, k_tile=256, **nk)
            got = nm_spmm.nm_gather_seq_policy_matmul(x, nv, ni, **kw)
            want = nm_spmm.nm_gather_seq_policy_matmul_ref(x, nv, ni, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), policy
        return
    for policy in (("sorted",) if kernel == "chunked"
                   else ("sorted", "sorted_tiled")):
        kp = sm.padded_k(g * 16, policy, 256)
        nv, ni = _negative_slabs(vals, idx, 16, kp)
        kw = dict(acc_bits=16, rounds=1, **nk)
        tk = dict(kw, k_tile=256)
        if kernel == "sort":
            args = (x, nv, ni)
            kern, ref = (nm_spmm.nm_gather_sort_matmul,
                         nm_spmm.nm_gather_sort_matmul_ref)
            kw = dict(tk, policy=policy)
        elif kernel == "chunked":
            args = (x, nv, ni)
            kern, ref = (ss.nm_gather_chunked_sort_matmul,
                         ss.nm_gather_chunked_sort_matmul_ref)
        elif kernel == "sums":
            if policy == "sorted":
                continue
            args, kw = (x, nv, ni), dict(k_tile=256, **nk)
            kern, ref = ss.nm_gather_tile_sums, ss.nm_gather_tile_sums_ref
        else:
            if policy == "sorted":
                continue
            perm = pair_permutation(ss.nm_gather_tile_sums_ref(
                x, nv, ni, k_tile=256, **nk)).to(torch.int32)
            args, kw = (x, nv, ni, perm), tk
            kern, ref = (ss.nm_gather_paired_accum_matmul,
                         ss.nm_gather_paired_accum_matmul_ref)
        got = kern(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), policy


def _stacked_slabs(vals, idx, m_group):
    """Non-canonical slabs for the expand twin's merged slots: each group's
    slots reversed (descending indices), in every third group slot 0 at
    the last slot's position (a duplicate), in every fourth slot 1 outside
    its group (index m_group, then -1), and in every fifth every slot at
    position 0 with value 127 (a merged weight past int8)."""
    vals, idx = _non_canonical(vals, idx)
    idx[:, ::4, 1] = m_group
    idx[:, 2::8, 1] = -1
    idx[:, ::5, :] = 0
    vals[:, ::5, :] = 127
    return vals, idx


@pytest.mark.parametrize("m", [1, 3, 4, 5, 128])
def test_rows_8_and_13_row_blocks(card, m):
    """Row 8 (``nm_gather_sort_matmul``, both policies: a block per
    compressed row and up to 4 rows of x, products formed once in shared
    memory) and row 13 (``nm_paired_accum_matmul``: the row's merged slots,
    or with no round its expanded row, shared by up to 4 rows of x)
    against their plain versions at M 1, 3, 4, 5 and 128, rounds 0 to 2,
    on canonical slabs, on non-canonical ones (``_stacked_slabs``: merged
    weights past int8 for row 13) and at K short of kp (1000: kp 1024)."""
    for k in (1536, 1000):
        x, _, vals, idx = _nm_w(m, k, 45, 8, 16, m + k, card, None)
        nk = dict(m_group=16)
        for slabs in ((vals, idx), _stacked_slabs(vals, idx, 16)):
            perm = pair_permutation(ss.nm_tile_sums_matmul_ref(
                x, *slabs, k_tile=256, **nk)).to(torch.int32)
            for rounds in (0, 1, 2):
                kw = dict(acc_bits=16, rounds=rounds, **nk)
                for policy in sm.SORT_POLICIES:
                    tk = dict(kw, policy=policy, k_tile=256)
                    got = nm_spmm.nm_gather_sort_matmul(x, *slabs, **tk)
                    want = nm_spmm.nm_gather_sort_matmul_ref(x, *slabs, **tk)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (k, policy, rounds)
                tk = dict(kw, k_tile=256)
                got = ss.nm_paired_accum_matmul(x, *slabs, perm, **tk)
                want = ss.nm_paired_accum_matmul_ref(x, *slabs, perm, **tk)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (k, rounds)


PASS2_MS = (1, 3, 4, 5, 9)  # around the pass-2 kernels' blocks of 4 rows
# nonzero products of tiles 0-2 of the constructed rows 0-4 of w (against
# rows of x with no zero): each side of the 64-, 128- and 256-key networks
PASS2_NNZ = ((64, 65, 128), (129, 256, 64), (65, 129, 0), (128, 128, 129),
             (0, 0, 0))


def _pass2_dense(m, k, seed, card):
    """x (m, k) int8 with no zero (row 0 at +-127) and w (12, k): rows 0-4
    with exactly ``PASS2_NNZ`` nonzero products a tile of 256 (tile 2 cut
    to what lies before K), row 5 8:16-pruned, row 6 at 127, the rest
    random."""
    r = np.random.default_rng(seed)
    x = r.integers(1, 128, (m, k)) * np.where(r.random((m, k)) < 0.5, -1, 1)
    x[0] = 127 * np.where(r.random(k) < 0.3, -1, 1)
    w = r.integers(-127, 128, (12, k))
    w[w == 0] = 1
    for row, counts in enumerate(PASS2_NNZ):
        for t, nnz in enumerate(counts):
            tile = w[row, t * 256:(t + 1) * 256]
            tile[r.permutation(len(tile))[min(nnz, len(tile)):]] = 0
    w[6] = 127
    w = torch.from_numpy(w.astype(np.int8))
    w[5] = _prune(w[5:6], 8, 16)[0][0]
    return torch.from_numpy(x.astype(np.int8)).to(card), w.to(card)


@pytest.mark.parametrize("m", PASS2_MS)
def test_paired_accum_row_blocks(card, m):
    """Row 12 (``paired_accum_matmul``: up to 4 rows of x a block, the
    weight row and perm staged, each pair slot sorted on its nonzero
    products on the smallest network that holds them) against its plain
    version at M 1, 3, 4, 5 and 9: tiles of 64, 65, 128, 129 and 256
    nonzero products and all-zero ones, an odd T, K = kp and K short of
    kp, rounds 0 to 3, acc_bits 8, 16 and 30."""
    for k in (768, 700):
        x, w = _pass2_dense(m, k, m + k, card)
        perm = pair_permutation(ss.tile_sums_matmul(
            x, w, k_tile=256, kp=768)).to(torch.int32)
        for rounds in (0, 1, 2, 3):
            for acc_bits in (8, 16, 30):
                kw = dict(acc_bits=acc_bits, rounds=rounds, k_tile=256,
                          kp=768)
                got = ss.paired_accum_matmul(x, w, perm, **kw)
                want = ss.paired_accum_matmul_ref(x, w, perm, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (k, rounds, acc_bits)


@pytest.mark.parametrize("k,k_tile", [(8192, 1), (135168, 1024)])
def test_paired_accum_unstaged(card, k, k_tile):
    """Row 12 where its shared memory does not hold the block's rows of
    perm (k_tile 1: 8192 tiles a row) or the weight row (K = 135168)
    against its plain version, which then read device memory; each pair
    slot sorted on its nonzero products at k_tile 1024."""
    x, w = _xw(5, k, 3, k + k_tile, card)
    w[1, ::3] = 0
    perm = pair_permutation(ss.tile_sums_matmul(x, w, k_tile=k_tile)).to(
        torch.int32)
    for rounds in (0, 1):
        kw = dict(acc_bits=16, rounds=rounds, k_tile=k_tile)
        got = ss.paired_accum_matmul(x, w, perm, **kw)
        want = ss.paired_accum_matmul_ref(x, w, perm, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), rounds


@pytest.mark.parametrize("m", PASS2_MS)
def test_nm_gather_paired_accum_row_blocks(card, m):
    """Row 14 (``nm_gather_paired_accum_matmul``: a compressed row decoded
    once into products for up to 4 rows of x, their perm in shared memory)
    against its plain version at M 1, 3, 4, 5 and 9: 8:16 at k_tile 256
    and 2:4 at k_tile 64, K = kp (1536) and K short of kp (1000), canonical
    and non-canonical slabs, rounds 0 to 3, acc_bits 8, 16 and 30; and past
    ``kStagePositions`` (K = 16896), where the kernel of one output a block
    stands."""
    for k, n_keep, m_group, k_tile in ((1536, 8, 16, 256), (1000, 8, 16, 256),
                                       (1000, 2, 4, 64),
                                       (16896, 8, 16, 256)):
        x, _, vals, idx = _nm_w(m, k, 21, n_keep, m_group, m + k + n_keep,
                                card)
        nk = dict(m_group=m_group)
        for slabs in ((vals, idx), _non_canonical(vals, idx)):
            perm = pair_permutation(ss.nm_gather_tile_sums_ref(
                x, *slabs, k_tile=k_tile, **nk)).to(torch.int32)
            for rounds in (0, 1, 2, 3):
                for acc_bits in (8, 16, 30):
                    kw = dict(acc_bits=acc_bits, rounds=rounds,
                              k_tile=k_tile, **nk)
                    got = ss.nm_gather_paired_accum_matmul(x, *slabs, perm,
                                                           **kw)
                    want = ss.nm_gather_paired_accum_matmul_ref(
                        x, *slabs, perm, **kw)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (k, rounds, acc_bits)


@pytest.mark.parametrize("n_keep,m_group", [(8, 16), (4, 16), (2, 8),
                                            (16, 16), (3, 12), (8, 32)])
def test_nm_spmm_duplicate_slots_past_int8(card, n_keep, m_group):
    """Row 4 where two nonzero slots name one position and their sum leaves
    int8: the smallest case gives the plain version's (254, 32258) (a byte
    of the tile would wrap it to (-2, -254)), and at each loader's shapes
    (m_group dividing 16: NmChunks, with 16:16's byte adds; else NmBytes)
    at decode and prefill M the result equals the plain version's."""
    x, vals, idx = smallest_duplicate(torch, card)
    got = nm_spmm.nm_spmm(x, vals, idx, m_group=16)
    torch.cuda.synchronize()
    assert got.flatten().tolist() == [254, 32258]
    for m, k, n in ((4, 1536, 256), (128, 300, 70), (17, 8960, 64)):
        x, _, vals, idx = _nm_w(m, k, n, n_keep, m_group, m + n_keep, card)
        sv, si = stacked_slabs(torch, vals, idx)
        got = nm_spmm.nm_spmm(x, sv, si, m_group=m_group)
        want = nm_spmm.nm_spmm_ref(x, sv, si, m_group=m_group)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, k, n)


# (M, N, K, n_keep, m_group, k_tile) of row 5's packed expand kernel: an
# output's steps on 1, 2, 4 and 8 warps (N * ceil(M / 4) warps against
# the 8448 that fill the card), a block of 1, 2 and 4 groups of 4 rows
# (M 7 and 13 in one step, 128), K past a window of staged positions
# (8960, 20000, 65536), ragged K and G (K not a multiple of m_group),
# n_keep = m (dense tiles), M 1, 3, 4, 5, 9 and 128, tiles of 16 to 1024
EXPAND_SEQ_CASES = (
    (1, 1, 16, 8, 16, 16), (3, 70, 300, 3, 16, 64),
    (5, 256, 1536, 8, 16, 256), (9, 70, 4000, 16, 16, 1024),
    (4, 70, 8960, 8, 16, 256), (8, 1536, 1536, 8, 16, 256),
    (12, 1536, 1536, 8, 16, 256), (128, 1536, 1536, 8, 16, 256),
    (1, 70, 65536, 4, 16, 512), (5, 3, 20000, 2, 4, 16),
    (7, 70, 200, 8, 16, 256), (13, 37, 1000, 4, 16, 1024),
)


@pytest.mark.parametrize("case", EXPAND_SEQ_CASES, ids=str)
def test_nm_expand_seq_packed_split(card, case):
    """Row 5 (``nm_seq_policy_matmul``) against its plain version under
    every policy (``sorted_tiled_seq`` at rounds 0 to 3 with acc_bits 2,
    16 and 30; ``clip`` and ``wrap`` at 2, 16 and 30; ``wide``) and, on
    canonical slabs, against the dense kernel on the decompressed weight
    and the gather kernel; on non-canonical slabs (unsorted indices, a
    second slot at a kept position) against the plain version."""
    m, n, k, n_keep, m_group, k_tile = case
    x, w, vals, idx = _nm_w(m, k, n, n_keep, m_group, m + n + k, card)
    nv, ni = _non_canonical(vals, idx)
    runs = [("sorted_tiled_seq", r, b) for r in range(4) for b in (2, 16, 30)]
    runs += [(p, 1, b) for p in ("clip", "wrap") for b in (2, 16, 30)]
    runs += [("wide", 1, 16)]
    for policy, rounds, acc_bits in runs:
        kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
                  rounds=rounds, k_tile=k_tile)
        got = nm_spmm.nm_seq_policy_matmul(x, vals, idx, **kw)
        want = nm_spmm.nm_seq_policy_matmul_ref(x, vals, idx, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (policy, rounds, acc_bits)
        if acc_bits == 16 and rounds == 1:
            dense = sm.seq_policy_matmul(
                x, w, policy=policy, acc_bits=acc_bits, rounds=rounds,
                k_tile=k_tile)
            gather = nm_spmm.nm_gather_seq_policy_matmul(x, vals, idx, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, dense), policy
            assert torch.equal(got, gather), policy
            got = nm_spmm.nm_seq_policy_matmul(x, nv, ni, **kw)
            want = nm_spmm.nm_seq_policy_matmul_ref(x, nv, ni, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (policy, "non-canonical")


@pytest.mark.parametrize("m,k", [(2, 16), (4, 1536), (5, 8960), (128, 300),
                                 (13, 200)])
def test_nm_expand_seq_duplicates_past_int8(card, m, k):
    """Row 5 where two nonzero slots name one position, their weight 254
    or -256 (past int8; -256 times x = -128 is past int16 too): under all
    four policies the expansion reports it and the block takes the int32
    route (the tensor-core kernel's exact sums under ``wide`` and
    ``wrap``), equal to the plain version; (2, 16) is the smallest
    case, (13, 200) a block of 4 groups of 4 rows."""
    m_group = 16
    if k == 16:
        x, vals, idx = smallest_duplicate(torch, card)
    else:
        x, _, vals, idx = _nm_w(m, k, 37, 8, m_group, m + k, card)
        vals, idx = stacked_slabs(torch, vals, idx)
    runs = [("sorted_tiled_seq", r, b) for r in range(4) for b in (2, 16, 30)]
    runs += [(p, 1, b) for p in ("clip", "wrap", "wide") for b in (2, 16, 30)]
    for policy, rounds, acc_bits in runs:
        for k_tile in (16, 256):
            kw = dict(m_group=m_group, policy=policy, acc_bits=acc_bits,
                      rounds=rounds, k_tile=k_tile)
            got = nm_spmm.nm_seq_policy_matmul(x, vals, idx, **kw)
            want = nm_spmm.nm_seq_policy_matmul_ref(x, vals, idx, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (policy, rounds, acc_bits, k_tile)
    if k == 16:
        wide = nm_spmm.nm_seq_policy_matmul(x, vals, idx, m_group=16,
                                            policy="wide")
        assert wide.flatten().tolist() == [254, 32258]


# (K, N, M rows, weight/activation bits): the paper nets' layers, conv1's
# K = 36 and conv2's 144 below k_tile 256, conv1's 49 patch rows an image
# at a ragged 20090 rows (410 test images), 5-bit codes
PAPER_SHAPES = ((36, 16, 20090, 8), (144, 32, 6560, 8), (512, 10, 410, 8),
                (784, 784, 410, 8), (784, 10, 410, 8), (784, 784, 410, 5))


@pytest.mark.parametrize("k,n,m,bits", PAPER_SHAPES)
def test_quant_linear_int_fwd_paper_shapes(card, k, n, m, bits):
    """quant_linear_int_fwd at the paper nets' shapes, asymmetric
    activation offsets: each of its integer dots (rows 1 and 2, 128-row
    chunks) equals the plain version on the same operands under sorted,
    sorted_tiled, clip and wide."""
    from repro_torch.core import dispatch, pqs
    from repro_torch.core.quant import EmaRange

    g = torch.Generator(device="cuda").manual_seed(k + n + bits)
    layer = pqs.quant_linear_init(g, k, n)
    x = torch.rand((m, k), generator=g, device="cuda") * 3.0 - 0.5
    layer["act_range"] = EmaRange(torch.tensor(-0.5, device="cuda"),
                                  torch.tensor(2.5, device="cuda"), n=500.0)
    if k % 16 == 0:
        layer["mask"] = nm_prune_mask(layer["w"], 8, 16)
    with DotRecorder(dispatch) as rec:
        for policy in ("sorted", "sorted_tiled", "clip", "wide"):
            for acc in (12, 16, 20):
                cfg = pqs.PQSConfig(weight_bits=bits, act_bits=bits,
                                    acc_bits=acc, policy=policy)
                frozen = pqs.quant_linear_freeze(layer, cfg)
                assert int(frozen["x_qp"].offset) != 0
                pqs.quant_linear_int_fwd(frozen, x, cfg)
    torch.cuda.synchronize()
    assert rec.plain_errors(torch) == (0, 12)


# (N, K) of gemma3-12b's projection sites: wq, wk / wv, wo, w_gate / w_up,
# w_out (K = 3840, 4096 and 15360; N = 2048 to 15360)
GEMMA3_SITES = ((4096, 3840), (2048, 3840), (3840, 4096), (15360, 3840),
                (3840, 15360))


@pytest.mark.parametrize("n,k", GEMMA3_SITES)
def test_rows_1_and_6_at_gemma3_sites(card, n, k):
    """Rows 1 and 6 at decode (M = 4) under ``sorted_tiled_seq`` (16-bit
    register, k_tile 256), 8:16 slabs: each equals its plain version, and
    row 6 equals row 1 on the decompressed weight."""
    x, w, vals, idx = _nm_w(4, k, n, 8, 16, n + k, card)
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=256)
    dense = sm.seq_policy_matmul(x, w, **kw)
    gather = nm_spmm.nm_gather_seq_policy_matmul(x, vals, idx, m_group=16,
                                                 **kw)
    torch.cuda.synchronize()
    assert torch.equal(dense, sm.seq_policy_matmul_ref(x, w, **kw))
    assert torch.equal(gather, nm_spmm.nm_gather_seq_policy_matmul_ref(
        x, vals, idx, m_group=16, **kw))
    assert torch.equal(gather, dense)


def test_row_1_at_qwen3_head(card):
    """Row 1 at qwen3-32b's untied head (N = 151936, K = 5120, M = 4): the
    grid's far end included. Each output reads only its own weight row, so
    the first and last 2048 columns are held against the plain version on
    those rows alone."""
    n, k = 151936, 5120
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(-128, 128, (4, k), generator=g, device=card,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=card,
                      dtype=torch.int8)
    x[0] = 127
    w[0] = 127
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=256)
    got = sm.seq_policy_matmul(x, w, **kw)
    torch.cuda.synchronize()
    for cols in (slice(0, 2048), slice(n - 2048, n)):
        assert torch.equal(got[:, cols], sm.seq_policy_matmul_ref(
            x, w[cols].contiguous(), **kw)), cols


# (N, K) of mamba2-2.7b's in_proj (N = 10576 = 32 * 330 + 16: a partial
# last output block) and out_proj, and granite-moe-3b's wk / wv
MOE_SSM_SITES = ((10576, 2560), (2560, 5120), (512, 1536))


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("n,k", MOE_SSM_SITES)
def test_rows_1_and_6_at_moe_ssm_sites(card, n, k, m):
    """Rows 1 and 6 at decode (M = 4) and a prefill cohort (M = 128) under
    ``sorted_tiled_seq`` (16-bit register, k_tile 256), 8:16 slabs: every
    output equal to the plain version's (the ragged last block of
    in_proj's N included), and row 6 equal to row 1 on the decompressed
    weight."""
    x, w, vals, idx = _nm_w(m, k, n, 8, 16, n + k + m, card)
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=256)
    dense = sm.seq_policy_matmul(x, w, **kw)
    gather = nm_spmm.nm_gather_seq_policy_matmul(x, vals, idx, m_group=16,
                                                 **kw)
    torch.cuda.synchronize()
    assert dense.shape == (m, n)
    assert torch.equal(dense, sm.seq_policy_matmul_ref(x, w, **kw))
    assert torch.equal(gather, nm_spmm.nm_gather_seq_policy_matmul_ref(
        x, vals, idx, m_group=16, **kw))
    assert torch.equal(gather, dense)


# (N, K) of the rest of the zoo: jamba-v0.1-52b's in_proj (N = 16544 = 32 *
# 517), whisper-medium's w_out (K = 4096) and qwen2-vl-72b's MLP w_out (K =
# 29568 = 115.5 k_tiles of 256: a partial last tile)
ZOO_SITES = ((16544, 4096), (1024, 4096), (8192, 29568))


@pytest.mark.parametrize("n,k", ZOO_SITES)
def test_rows_1_and_6_at_zoo_sites(card, n, k):
    """Rows 1 and 6 at decode (M = 4) under ``sorted_tiled_seq`` (16-bit
    register, k_tile 256), 8:16 slabs: each equals its plain version, and
    row 6 equals row 1 on the decompressed weight."""
    x, w, vals, idx = _nm_w(4, k, n, 8, 16, n + k, card)
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=256)
    dense = sm.seq_policy_matmul(x, w, **kw)
    gather = nm_spmm.nm_gather_seq_policy_matmul(x, vals, idx, m_group=16,
                                                 **kw)
    torch.cuda.synchronize()
    assert dense.shape == (4, n)
    assert torch.equal(dense, sm.seq_policy_matmul_ref(x, w, **kw))
    assert torch.equal(gather, nm_spmm.nm_gather_seq_policy_matmul_ref(
        x, vals, idx, m_group=16, **kw))
    assert torch.equal(gather, dense)
