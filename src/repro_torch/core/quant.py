"""Uniform quantization primitives (paper section 2.1), torch port of
``repro.core.quant``.

Per-tensor uniform quantization of weights (symmetric, o_w = 0) and
activations (asymmetric, offset o_x) to b-bit signed integers, the
straight-through fake-quant of QAT, and the activation-range observers.
Integer values are carried in int32 whatever the logical width b; the
width is enforced by the clip bounds. Float arithmetic is float32
throughout, as in the JAX package, and rounding is half to even
(``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def qrange(bits: int) -> tuple[int, int]:
    """Signed integer range [-2^(b-1), 2^(b-1)-1] for a b-bit value."""
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class QParams:
    """Quantization parameters for one tensor (per-tensor granularity).

    ``symmetric`` marks params whose offset is identically zero, so the
    integer dot may skip the offset correction.
    """

    scale: torch.Tensor  # f32 scalar (or one per stacked layer)
    offset: torch.Tensor  # i32 scalar (0 for symmetric params)
    bits: int
    symmetric: bool = False


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _div(t: torch.Tensor, v: float) -> torch.Tensor:
    """t / v rounded once on every device: PyTorch's CUDA kernels divide
    by a Python number (a CPU scalar) as a multiply by its reciprocal, two
    roundings, where the CPU divides, so a layer frozen on the card would
    differ from the CPU's in the last place."""
    return torch.div(t, torch.full_like(t, v))


def _symmetric(amax: torch.Tensor, bits: int) -> QParams:
    _, qmax = qrange(bits)
    scale = _div(amax.to(torch.float32), qmax)
    return QParams(scale, torch.zeros((), dtype=torch.int32,
                                      device=scale.device), bits,
                   symmetric=True)


def weight_qparams(w: torch.Tensor, bits: int) -> QParams:
    """Symmetric per-tensor weight params (o_w = 0, paper section 2.1);
    an all-zero tensor takes amax 1e-8."""
    return _symmetric(torch.clamp(w.abs().max(), min=1e-8), bits)


def activation_qparams(lo, hi, bits: int) -> QParams:
    """Asymmetric activation params from a calibrated range [lo, hi]
    (paper Eq. 1): s_x = R / (2^b - 1), o_x = -2^(b-1) - round(lo / s_x),
    the range widened to hold 0 so that zero maps to an integer."""
    # minimum / maximum split a tie's gradient as jnp.minimum / maximum
    # do (a ReLU input's range starts exactly at 0); torch.clamp would not
    lo, hi = _f32(lo), _f32(hi)
    lo = torch.minimum(lo, torch.zeros_like(lo))
    hi = torch.maximum(hi, torch.zeros_like(hi))
    r = torch.maximum(hi - lo, torch.full_like(hi, 1e-8))
    scale = _div(r, 2**bits - 1)
    qmin, _ = qrange(bits)
    offset = qmin - torch.round(lo / scale)
    return QParams(scale, offset.to(torch.int32), bits)


def symmetric_activation_qparams(lo, hi, bits: int) -> QParams:
    """Offset-free activation params: scale = max(|lo|, |hi|) /
    (2^(b-1) - 1). Up to one bit of range for no o_x * sum(w) term."""
    amax = torch.clamp(torch.maximum(_f32(lo).abs(), _f32(hi).abs()),
                       min=1e-8)
    return _symmetric(amax, bits)


def quantize(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Float -> int32 carrier of a qp.bits-bit signed value (Eq. 1)."""
    qmin, qmax = qrange(qp.bits)
    q = torch.round(x / qp.scale) + qp.offset
    return torch.clamp(q, qmin, qmax).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Float32 value s (q - o) of integer codes (Eq. 2)."""
    return (q.to(torch.float32) - qp.offset.to(torch.float32)) * qp.scale


def fake_quant(x: torch.Tensor, qp: QParams) -> torch.Tensor:
    """Quantize-dequantize with a clipped straight-through estimator.

    Forward: dequantize(quantize(x)). Backward: the gradient of the clip,
    1 inside the range, 0 outside, and 0.5 at a point exactly on a bound:
    ``jnp.clip`` is a max then a min, whose gradients split a tie evenly,
    and ``torch.maximum``/``torch.minimum`` split it the same way
    (``torch.clamp`` would pass 1 there).
    """
    qmin, qmax = qrange(qp.bits)
    lo = (qmin - qp.offset).to(torch.float32) * qp.scale
    hi = (qmax - qp.offset).to(torch.float32) * qp.scale
    x_c = torch.minimum(torch.maximum(x, lo), hi)
    y = dequantize(quantize(x_c, qp), qp)
    return x_c + (y - x_c).detach()


@dataclasses.dataclass
class EmaRange:
    """Exponential-moving-average activation range observer (paper
    section 2.1), updated functionally. ``lo``/``hi`` are the raw
    zero-initialised averages; ``bounds()`` applies the 1 - decay^n bias
    correction (Adam's debiasing) and is what consumers read.

    ``n``, the number of updates, is counted on the host, and the
    correction is taken in float32 by numpy, as the JAX package's float32
    ``pow`` gives it: the same value on the CPU and on the card, whose
    ``powf`` may differ from the host's in the last place."""

    lo: torch.Tensor
    hi: torch.Tensor
    decay: float = 0.99
    n: float = 0.0

    def update(self, x: torch.Tensor) -> "EmaRange":
        return self.update_bounds(x.min(), x.max())

    def update_bounds(self, blo, bhi) -> "EmaRange":
        new_lo = self.decay * self.lo + (1 - self.decay) * blo
        new_hi = self.decay * self.hi + (1 - self.decay) * bhi
        return EmaRange(new_lo, new_hi, self.decay, float(self.n) + 1.0)

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Bias-corrected (lo, hi) calibrated range."""
        f32 = np.float32
        corr = float(max(f32(1.0) - f32(self.decay) ** f32(self.n),
                         f32(1e-8)))
        return _div(self.lo, corr), _div(self.hi, corr)

    @staticmethod
    def init() -> "EmaRange":
        zero = torch.zeros((), dtype=torch.float32)
        return EmaRange(zero, zero)


class ActCalibrator:
    """Host-side per-site activation-range collector (paper section 2.1).

    Sites are named projection call sites ("wq", "w_gate", ...). A
    calibration pass reports each call's (min, max) with ``observe`` (host
    floats or 0-d tensors), tracked per site by a bias-corrected
    ``EmaRange``; ``freeze`` turns the corrected bounds into static
    ``QParams``.
    """

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ranges: dict[str, EmaRange] = {}

    def observe(self, site: str, lo, hi) -> None:
        er = self.ranges.get(site)
        if er is None:
            zero = torch.zeros((), dtype=torch.float32)
            er = EmaRange(zero, zero, self.decay)
        self.ranges[site] = er.update_bounds(_f32(lo).cpu(), _f32(hi).cpu())

    def freeze(self, bits: int = 8, symmetric: bool = True
               ) -> dict[str, QParams]:
        """Bias-corrected static QParams per calibrated site."""
        make = symmetric_activation_qparams if symmetric \
            else activation_qparams
        return {site: make(*er.bounds(), bits)
                for site, er in self.ranges.items()}


def quantized_dot_terms(wq: torch.Tensor, xq: torch.Tensor, x_qp: QParams
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial products and the activation-offset correction term.

    With o_w = 0, Eq. (3) is z = s_w s_x [sum_k w_k x_k - o_x sum_k w_k]:
    returns (partial products w_k * x_k as int32, o_x * sum_k w_k), the
    first the integer dot PQS accumulates in a narrow register.
    """
    prods = wq.to(torch.int32) * xq.to(torch.int32)
    corr = x_qp.offset.to(torch.int32) * wq.to(torch.int32).sum(
        dim=-1, dtype=torch.int32)
    return prods, corr
