"""The wide matmuls (``quant_matmul``, ``nm_spmm``), the port's kernel
oracles (``kernels.ref``), the quickstart entry points of ``kernels.ops``
and the whole torch quickstart, against the JAX package.

Inputs are drawn with numpy from a seed and fed to both packages on the
CPU; the JAX package's Pallas kernels run in interpret mode, as its own
tests run them, and the port's wrappers take their plain versions (the
CPU tensors' route). Every result is an integer and compared bit-exact.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import nm_compress as j_nm_compress
from repro.core.pruning import nm_prune_mask as j_nm_prune_mask
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import quickstart
from repro_torch.kernels import nm_spmm as tnm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _int8(r, shape, lo=-128, hi=128):
    return r.integers(lo, hi, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "m,k,n,bm,bn,bk",
    [(16, 64, 16, 8, 8, 32), (32, 128, 24, 16, 8, 64), (7, 50, 9, 8, 8, 32)],
)
def test_quant_matmul_sweep_matches_jax_kernel(m, k, n, bm, bn, bk):
    """The sweep of the JAX package's kernel test: the port equals the
    interpret-mode Pallas kernel and both oracles."""
    r = np.random.default_rng(m * 1000 + k + n)
    x, w = _int8(r, (m, k), -127, 127), _int8(r, (k, n), -127, 127)
    got = tops.quant_matmul(_t(x), _t(w))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    _eq(got, jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), bm=bm, bn=bn,
                               bk=bk))
    _eq(got, jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    _eq(tref.quant_matmul_ref(_t(x), _t(w)), got)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 8960, 37), (17, 300, 70),
                                   (128, 1536, 13), (3, 33, 129)])
def test_quant_matmul_edges_match_jax(m, k, n):
    """Ragged M, N, K (none a multiple of 8), K = 8960, and the int8
    extremes: rows of x all 127 / -128 against columns of w all -128 /
    127 (each such sum at the largest magnitude the int8 range gives)."""
    r = np.random.default_rng(m + 7 * n)
    x, w = _int8(r, (m, k)), _int8(r, (k, n))
    x[0], w[:, 0] = -128, -128
    if m > 1:
        x[-1] = 127
    if n > 1:
        w[:, -1] = 127
    got = tqm.quant_matmul(_t(x), _t(w))
    _eq(got, jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    assert int(got[0, 0]) == 128 * 128 * k
    carrier = tqm.quant_matmul(_t(x).to(torch.int32), _t(w).to(torch.int32))
    _eq(carrier, got)


def test_quant_matmul_wraps_as_jax():
    """Past 2^31 the int32 sum wraps in both (the kernels' contract):
    K = 2^17 + 8 products of (-128) * (-128)."""
    k = 2**17 + 8
    x = np.full((1, k), -128, np.int8)
    w = np.full((k, 2), -128, np.int8)
    got = tqm.quant_matmul_ref(_t(x), _t(w))
    _eq(got, jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    assert int(got[0, 0]) == (128 * 128 * k + 2**31) % 2**32 - 2**31


def _nm_weight(r, n, k, n_keep, m_group):
    """An (n, k) int8 weight pruned n_keep:m_group by the JAX mask."""
    kp = k + (-k) % m_group
    w = np.pad(_int8(r, (n, k), -127, 127), ((0, 0), (0, kp - k)))
    mask = np.asarray(j_nm_prune_mask(jnp.asarray(w, jnp.float32), n_keep,
                                      m_group))
    return (w * mask).astype(np.int8)[:, :k]


@pytest.mark.parametrize("n_keep,m_group", [(4, 16), (8, 16), (2, 8)])
def test_nm_spmm_sweep_matches_jax_kernel(n_keep, m_group):
    """The sweep of the JAX package's kernel test: the port equals the
    interpret-mode Pallas kernel, the oracle on the slabs, and the wide
    matmul on the pruned weight."""
    r = np.random.default_rng(n_keep * 10 + m_group)
    wd = _nm_weight(r, 16, 128, n_keep, m_group)
    vals, idx = tops.compress_nm_weights(wd, n_keep, m_group)
    jvals, jidx = jops.compress_nm_weights(wd, n_keep, m_group)
    _eq(vals, jvals)
    _eq(idx, jidx)
    assert vals.dtype == torch.int8 and idx.dtype == torch.int32
    x = _int8(r, (12, 128), -127, 127)
    got = tops.nm_spmm(_t(x), vals, idx, m_group=m_group)
    _eq(got, jops.nm_spmm(jnp.asarray(x), jvals, jidx, m_group=m_group, bm=4,
                          bn=8, bg=2))
    _eq(got, jref.nm_spmm_ref(jnp.asarray(x), np.asarray(jvals),
                              np.asarray(jidx), m_group))
    _eq(got, jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(wd.T)))
    _eq(tref.nm_spmm_ref(_t(x), vals, idx, m_group), got)


@pytest.mark.parametrize("m,n,k,n_keep,m_group", [
    (1, 37, 300, 3, 16), (5, 70, 300, 2, 4), (17, 9, 1536, 8, 16),
    (4, 20, 8960, 8, 16), (3, 11, 160, 16, 16)])
def test_nm_spmm_ragged_matches_jax(m, n, k, n_keep, m_group):
    """Ragged M, N, K and G (a tail group past K), dense-as-sparse 16:16,
    x at the logical K, against the JAX oracle and the wide matmul on
    the decompressed weight."""
    r = np.random.default_rng(m * 100 + n + k)
    wd = _nm_weight(r, n, k, n_keep, m_group)
    vals, idx = j_nm_compress(wd, n_keep, m_group)
    x = _int8(r, (m, k))
    x[0] = -128
    got = tnm.nm_spmm(_t(x), _t(vals), _t(idx), m_group=m_group)
    xp = np.pad(x, ((0, 0), (0, vals.shape[1] * m_group - k)))
    _eq(got, jref.nm_spmm_ref(jnp.asarray(xp), vals, idx, m_group))
    _eq(got, tqm.quant_matmul(_t(x), _t(wd.T)))


def test_nm_spmm_padded_slots_match_jax():
    """Hand-packed slabs whose padded slots (value 0, index 0) follow a
    kept value at position 0 of their group: the scatter-add keeps the
    kept value, in the port's plain version, the JAX oracle and the JAX
    interpret-mode kernel."""
    r = np.random.default_rng(11)
    n, g, n_keep, m_group = 8, 6, 4, 16
    vals = _int8(r, (n, g, n_keep), -127, 127)
    idx = np.tile(np.array([0, 3, 7, 12], np.int32), (n, g, 1))
    vals[:, ::2, 2:] = 0  # padded slots at index 0 behind a kept value at 0
    idx[:, ::2, 2:] = 0
    vals[:, ::2, 0] = 127
    x = _int8(r, (5, g * m_group))
    got = tops.nm_spmm(_t(x), _t(vals), _t(idx), m_group=m_group)
    _eq(got, jref.nm_spmm_ref(jnp.asarray(x), vals, idx, m_group))
    _eq(got, jops.nm_spmm(jnp.asarray(x), jnp.asarray(vals),
                          jnp.asarray(idx), m_group=m_group, bm=8, bn=8,
                          bg=2))


def test_nm_spmm_refuses_bad_slabs():
    x = torch.zeros((2, 64), dtype=torch.int8)
    v = torch.zeros((3, 4, 8), dtype=torch.int8)
    i = torch.zeros((3, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="contraction"):
        tnm.nm_spmm(torch.zeros((2, 65), dtype=torch.int8), v, i, m_group=16)
    with pytest.raises(ValueError, match="n_keep"):
        tnm.nm_spmm(x, v, i, m_group=4)
    with pytest.raises(ValueError, match="matching"):
        tnm.nm_spmm(x, v, i[:, :3], m_group=16)
    with pytest.raises(ValueError, match="expected x"):
        tqm.quant_matmul(x, torch.zeros((63, 3), dtype=torch.int8))


@pytest.mark.parametrize("acc_bits", [12, 16, 20])
@pytest.mark.parametrize("rounds", [1, 2])
def test_sorted_and_clip_matmul_match_jax_oracles(acc_bits, rounds):
    """ops.sorted_matmul / clip_matmul and the port's oracles against the
    JAX oracles (post-ReLU x, as the JAX kernel sweep draws)."""
    r = np.random.default_rng(acc_bits * 3 + rounds)
    x, w = _int8(r, (8, 64), 0, 127), _int8(r, (12, 64), -127, 127)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    want = jref.sorted_matmul_ref(jx, jw, acc_bits=acc_bits, rounds=rounds,
                                  k_tile=32)
    _eq(tops.sorted_matmul(_t(x), _t(w), acc_bits=acc_bits, rounds=rounds,
                           bk=32), want)
    _eq(tref.sorted_matmul_ref(_t(x), _t(w), acc_bits=acc_bits,
                               rounds=rounds, k_tile=32), want)
    want = jref.clip_matmul_ref(jx, jw, acc_bits=acc_bits)
    _eq(tops.clip_matmul(_t(x), _t(w), acc_bits=acc_bits, bk=32), want)
    _eq(tref.clip_matmul_ref(_t(x), _t(w), acc_bits=acc_bits), want)


def test_sorted_and_clip_matmul_match_jax_kernels():
    """Against the JAX entry points in interpret mode: the ragged-padding
    case of the JAX sweep (K = 48 at bk 16) and the transient case, where
    the sorted result is exact on more in-range outputs than clip."""
    r = np.random.default_rng(0)
    x, w = _int8(r, (5, 48), -50, 50), _int8(r, (6, 48), -50, 50)
    _eq(tops.sorted_matmul(_t(x), _t(w), acc_bits=18, bk=16),
        jops.sorted_matmul(jnp.asarray(x), jnp.asarray(w), acc_bits=18,
                           bm=4, bn=4, bk=16))
    x, w = _int8(r, (16, 128), 0, 127), _int8(r, (32, 128), -127, 127)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    srt = tops.sorted_matmul(_t(x), _t(w), acc_bits=18, bk=128)
    clp = tops.clip_matmul(_t(x), _t(w), acc_bits=18, bk=128)
    _eq(srt, jops.sorted_matmul(jx, jw, acc_bits=18, bm=8, bn=8, bk=128))
    _eq(clp, jops.clip_matmul(jx, jw, acc_bits=18, bm=8, bn=8, bk=128))
    wide = tops.quant_matmul(_t(x), _t(w.T))
    fits = wide.abs() <= 2**17 - 1
    assert (srt == wide)[fits].double().mean() >= (
        clp == wide)[fits].double().mean()


@pytest.mark.parametrize("acc_bits", [10, 16])
@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_sorted_dot_ref_matches_jax(acc_bits, rounds):
    r = np.random.default_rng(acc_bits + rounds)
    prods = (r.integers(0, 128, (6, 96)) * r.integers(-128, 128, (6, 96))
             ).astype(np.int32)
    tv, tovf = tref.sorted_dot_ref(_t(prods), acc_bits, rounds)
    jv, jovf = jref.sorted_dot_ref(jnp.asarray(prods), acc_bits, rounds)
    _eq(tv, jv)
    _eq(tovf, jovf)


def _numbers(line):
    return re.findall(r"-?\d+(?:\.\d+)?|True|False", line)


def test_quickstart_prints_what_the_jax_example_prints(capsys):
    """The whole path: examples/quickstart.py (JAX, interpret mode) in a
    subprocess and repro_torch.quickstart.main on the CPU print the same
    lines in the same order, every number equal; only the device label
    differs ("interpret mode" against "cpu")."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    jax_out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart.py")],
        check=True, capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300).stdout.splitlines()
    got = quickstart.main(device="cpu")
    port_out = capsys.readouterr().out.splitlines()
    assert len(port_out) == len(jax_out) == 10
    for mine, theirs in zip(port_out, jax_out):
        if "interpret mode" in theirs:
            assert mine == theirs.replace("interpret mode", "cpu")
        else:
            assert mine == theirs
    nums = [n for line in jax_out for n in _numbers(line)]
    assert nums == [n for line in port_out for n in _numbers(line)]
    assert got["exact_sum"] == got["sorted_value"] == int(nums[1]) == -6240
    assert got["n_transient"] == 1 and got["natural_overflowed"]
    assert got["sorted_exact"] and got["compressed_equals_dense"]
    assert (got["compressed_elems"], got["dense_elems"]) == (16384, 32768)
    assert f"{got['sorted_kernel_pct']:.2f}" in jax_out[5]
    assert f"{got['clip_kernel_pct']:.2f}" in jax_out[6]


def test_quickstart_matmuls_match_the_jax_kernels(capsys):
    """Steps 4 and 5 of the torch quickstart, element by element: on the
    CPU each result equals the JAX package's kernel (interpret mode) or
    oracle on the same inputs: the wide product, the sorted and clip
    registers at 18 bits, the pruned weight, its slabs and the compressed
    and dense-on-pruned products."""
    _, got = quickstart.run(device="cpu")
    capsys.readouterr()
    x, w = got["x"].numpy(), got["w"].numpy()
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _eq(got["wide"], jref.quant_matmul_ref(jx, jnp.asarray(w.T)))
    _eq(got["sorted"], jops.sorted_matmul(jx, jw, acc_bits=18, bk=256))
    _eq(got["clip"], jops.clip_matmul(jx, jw, acc_bits=18, bk=256))
    mask = j_nm_prune_mask(jnp.asarray(w, jnp.float32), 4, 16)
    wp = (w * np.asarray(mask)).astype(np.int8)
    _eq(got["pruned"], wp)
    vals, idx = jops.compress_nm_weights(wp, 4, 16)
    _eq(got["values"], vals)
    _eq(got["indices"], idx)
    _eq(got["nm_spmm"], jops.nm_spmm(jx, vals, idx, m_group=16))
    _eq(got["dense_on_pruned"],
        jref.quant_matmul_ref(jx, jnp.asarray(wp.T)))


def test_quickstart_example_script_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], check=True, capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300).stdout
    assert "compressed matmul == dense-on-pruned: True" in out
    assert "(kernel, cpu)" in out


def test_quant_matmul_body_choice():
    """Row 3's CUDA body is a pure function of the shapes and addresses:
    the TMA-fed body where N and K are multiples of 16 and both operands
    16-byte aligned (a tensor map's row strides and base), else the
    KnRows body; on the CPU the wrapper runs the plain version whatever
    body is asked for."""
    assert tqm.quant_matmul_body(256, 1536, 0, 4096) == "tma"
    assert tqm.quant_matmul_body(8960, 1536, 512, 1024) == "tma"
    for args in ((70, 300, 0, 0), (129, 33, 0, 0), (256, 1536, 1, 0),
                 (256, 1536, 0, 4), (256, 1536, 8, 0), (16, 0, 0, 0)):
        assert tqm.quant_matmul_body(*args) == "kn_rows", args
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.integers(-128, 128, (5, 48)).astype(np.int8))
    w = torch.from_numpy(r.integers(-128, 128, (48, 16)).astype(np.int8))
    want = tqm.quant_matmul_ref(x, w)
    for body in (None, *tqm.BODIES):
        assert torch.equal(tqm.quant_matmul(x, w, body=body), want)
