"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. This file imports no JAX, so it runs where only the port is
installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.pruning import nm_compress, nm_prune_mask
from repro_torch.kernels import nm_spmm, ops
from repro_torch.kernels import sorted_matmul as sm

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


def test_engine_kernel_and_plain_agree(card):
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
                            int_lin=IntegerLinConfig(k_tile=64,
                                                     backend=backend))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.drain(reqs)
        outs[backend] = [q.output for q in reqs]
    assert outs["cuda"] == outs["torch"]


def _nm(m, k, n, n_keep, m_group, seed, card):
    """Seeded x (m, k) and n_keep:m_group slabs of an (n, k) weight."""
    x, w = _xw(m, k, n, seed, card)
    kp = k + (-k) % m_group
    wp = torch.nn.functional.pad(w, (0, kp - k)).float()
    w = (wp * nm_prune_mask(wp, n_keep, m_group))[:, :k].to(torch.int8)
    vals, idx = nm_compress(w, n_keep, m_group)
    return x, vals.contiguous(), idx.contiguous()


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
    for policy in ("sorted", "sorted_tiled"):  # no global-sort N:M kernel
        with pytest.raises(NotImplementedError):
            ops.nm_policy_matmul(x, vals, idx, m_group=8, policy=policy,
                                 k_tile=16)


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
