"""The port's quantization primitives against the JAX package's.

Each test draws its inputs with numpy from a seed and feeds the same
arrays to ``repro.core.quant`` (JAX, on the CPU) and
``repro_torch.core.quant`` (torch, CPU). Integer codes are compared
bit-exact; float results of the same float32 operations exactly, except
``EmaRange.bounds`` (rtol 1e-6: ``decay ** n`` is a float32 power, whose
last bit the two libraries may round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _eq(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def _qp_eq(t, j):
    _eq(t.scale, j.scale)
    _eq(t.offset, j.offset)
    assert (t.bits, t.symmetric) == (j.bits, j.symmetric)


def _draw(seed, shape=(64,), scale=3.0):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 4, 8, 12])
@pytest.mark.parametrize("kind", ["weight", "activation", "symmetric"])
def test_qparams_and_quantize_match_jax(bits, kind):
    """Scale and offset, then the codes of quantize and the float32 values
    of dequantize, on the same draws (ReLU-like for activations)."""
    x = _draw(bits)
    if kind == "activation":
        x = np.abs(x)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if kind == "weight":
        tqp, jqp = tq.weight_qparams(tx, bits), jq.weight_qparams(jx, bits)
    else:
        name = {"activation": "activation_qparams",
                "symmetric": "symmetric_activation_qparams"}[kind]
        tqp = getattr(tq, name)(tx.min(), tx.max(), bits)
        jqp = getattr(jq, name)(jnp.min(jx), jnp.max(jx), bits)
    _qp_eq(tqp, jqp)
    codes = tq.quantize(tx, tqp)
    assert codes.dtype == torch.int32
    _eq(codes, jq.quantize(jx, jqp))
    _eq(tq.dequantize(codes, tqp), jq.dequantize(jnp.asarray(codes.numpy()),
                                                 jqp))


def test_qparams_degenerate_ranges_match_jax():
    """All-zero weights (amax floored at 1e-8), an all-negative and a
    one-point activation range (widened to hold 0), and host floats."""
    z = np.zeros(8, np.float32)
    _qp_eq(tq.weight_qparams(torch.from_numpy(z), 8),
           jq.weight_qparams(jnp.asarray(z), 8))
    for lo, hi in ((-3.0, -1.0), (0.0, 0.0), (0.5, 0.5), (-2.5, 7.25)):
        for name in ("activation_qparams", "symmetric_activation_qparams"):
            _qp_eq(getattr(tq, name)(lo, hi, 8),
                   getattr(jq, name)(jnp.float32(lo), jnp.float32(hi), 8))


def test_quantize_rounds_half_to_even_like_jax():
    """Values exactly half-way between codes round to even in both."""
    x = np.arange(-6, 7, dtype=np.float32) + 0.5
    qp_t = tq.QParams(torch.tensor(1.0), torch.tensor(0, dtype=torch.int32),
                      8)
    qp_j = jq.QParams(jnp.float32(1.0), jnp.int32(0), 8)
    _eq(tq.quantize(torch.from_numpy(x), qp_t),
        jq.quantize(jnp.asarray(x), qp_j))
    assert tq.quantize(torch.tensor([0.5, 1.5, 2.5]), qp_t).tolist() == [
        0, 2, 2]


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_value_and_gradient_match_jax(bits):
    """Forward values and the straight-through gradient, with points
    exactly on the clip bounds lo and hi (where jnp.clip's max/min split
    the tie: gradient 0.5), one float32 step inside them, and outside."""
    w = np.array([1.0, -0.5], np.float32)
    tqp = tq.weight_qparams(torch.from_numpy(w), bits)
    jqp = jq.weight_qparams(jnp.asarray(w), bits)
    qmin, qmax = jq.qrange(bits)
    lo = np.float32((qmin - jqp.offset).astype(jnp.float32) * jqp.scale)
    hi = np.float32((qmax - jqp.offset).astype(jnp.float32) * jqp.scale)
    zero = np.float32(0)
    x = np.array([-2.0, lo, np.nextafter(lo, zero), -0.25, 0.3, 0.0,
                  np.nextafter(hi, zero), hi, 1.5, 2.0], np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tq.fake_quant(tx, tqp)
    out.sum().backward()
    jx = jnp.asarray(x)
    _eq(out, jq.fake_quant(jx, jqp))
    jgrad = jax.grad(lambda v: jq.fake_quant(v, jqp).sum())(jx)
    _eq(tx.grad, jgrad)
    assert tx.grad.tolist() == [0, 0.5, 1, 1, 1, 1, 1, 0.5, 0, 0]


def test_fake_quant_gradient_on_random_draws_match_jax():
    """The gradient against asymmetric activation params calibrated on
    the draw itself (zero-offset range widened to hold 0)."""
    x = np.abs(_draw(3, (40,)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tqp = tq.activation_qparams(tx.detach().min(), tx.detach().max(), 8)
    jqp = jq.activation_qparams(jnp.min(jnp.asarray(x)),
                                jnp.max(jnp.asarray(x)), 8)
    w = _draw(4, (40,))
    (tq.fake_quant(tx, tqp) * torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda v: (jq.fake_quant(v, jqp) * jnp.asarray(w))
                     .sum())(jnp.asarray(x))
    _eq(tx.grad, jgrad)


def test_ema_range_matches_jax():
    """Functional updates from arrays and from host bounds, and the
    bias-corrected bounds (rtol 1e-6)."""
    te, je = tq.EmaRange.init(), jq.EmaRange.init()
    for i in range(12):
        x = _draw(20 + i, (32,), scale=1.0 + i)
        if i % 3 == 2:
            lo, hi = float(x.min()) - 1.0, float(x.max()) + 0.5
            te, je = te.update_bounds(lo, hi), je.update_bounds(lo, hi)
        else:
            te, je = te.update(torch.from_numpy(x)), je.update(jnp.asarray(x))
        np.testing.assert_allclose(te.lo.numpy(), np.asarray(je.lo),
                                   rtol=1e-6)
        np.testing.assert_allclose(te.hi.numpy(), np.asarray(je.hi),
                                   rtol=1e-6)
        for tb, jb in zip(te.bounds(), je.bounds()):
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    assert float(te.n) == float(je.n) == 12.0


@pytest.mark.parametrize("symmetric", [True, False])
def test_act_calibrator_matches_jax(symmetric):
    """Per-site EMA ranges from host floats and 0-d tensors, then the
    frozen QParams (scale rtol 1e-6, offsets exact)."""
    tc, jc = tq.ActCalibrator(decay=0.8), jq.ActCalibrator(decay=0.8)
    r = np.random.default_rng(5)
    for step in range(6):
        for site in ("wq", "w_gate"):
            lo = float(-abs(r.standard_normal()) * (step + 1))
            hi = float(abs(r.standard_normal()) * 3)
            tc.observe(site, torch.tensor(lo) if step % 2 else lo, hi)
            jc.observe(site, lo, hi)
    tfrozen, jfrozen = tc.freeze(8, symmetric), jc.freeze(8, symmetric)
    assert tfrozen.keys() == jfrozen.keys()
    for site, tqp in tfrozen.items():
        jqp = jfrozen[site]
        np.testing.assert_allclose(tqp.scale.numpy(), np.asarray(jqp.scale),
                                   rtol=1e-6)
        _eq(tqp.offset, jqp.offset)
        assert tqp.symmetric == jqp.symmetric == symmetric


@pytest.mark.parametrize("offset", [0, -128, 37])
def test_quantized_dot_terms_match_jax(offset):
    r = np.random.default_rng(offset + 200)
    wq = r.integers(-128, 128, (6, 48)).astype(np.int32)
    xq = r.integers(-128, 128, (48,)).astype(np.int32)
    tqp = tq.QParams(torch.tensor(0.1), torch.tensor(offset,
                                                     dtype=torch.int32), 8)
    jqp = jq.QParams(jnp.float32(0.1), jnp.int32(offset), 8)
    tp, tc = tq.quantized_dot_terms(torch.from_numpy(wq),
                                    torch.from_numpy(xq), tqp)
    jp, jc = jq.quantized_dot_terms(jnp.asarray(wq), jnp.asarray(xq), jqp)
    assert tp.dtype == tc.dtype == torch.int32
    _eq(tp, jp)
    _eq(tc, jc)
