"""A2Q baseline: accumulator-aware quantization (Colbert et al., ICCV'23),
torch port of ``repro.core.a2q``.

The paper's primary comparison point (paper section 3.1, Fig 5). A2Q
guarantees overflow-free accumulation into a p-bit register by bounding
each dot product's quantized weight L1 norm,

    sum_i |w_i^q| <= B := (2^(p-1) - 1) / 2^(b-1),

with per-output-channel weight quantization. The projection runs in the
integer domain, the only one where the bound is enforceable: quantize per
channel, then shrink each integer row multiplicatively and truncate toward
zero, which never lets the L1 norm pass the bound. During QAT it runs
inside a straight-through estimator.

Asymmetric tightening: serving clips activation codes to qrange(b) =
[-2^(b-1), 2^(b-1) - 1], so with wp / wn a row's positive / |negative|
weight sums the extreme partial sums under any order are

    pos(w) = qhi * wp + |qlo| * wn,    neg(w) = |qlo| * wp + qhi * wn,

and a p-bit register is safe iff pos <= 2^(p-1) - 1 and neg <= 2^(p-1).
Functions below take an optional frozen activation range (``act_qparams``
or ``act_bits``) and use the symmetric form without one.

Float32 caveat: the row sums are float32, exact up to 2^24;
``core.certify`` redoes the arithmetic on the host in int64 and is the
authority on the guarantee.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import qrange


def act_code_range(act_qparams=None, act_bits: Optional[int] = None
                   ) -> Optional[tuple[int, int]]:
    """Admissible integer activation codes at serving time, or None: the
    full signed range of the frozen width, which ``qtensor_dot`` clips
    every input to."""
    if act_qparams is not None:
        return qrange(int(act_qparams.bits))
    if act_bits is not None:
        return qrange(int(act_bits))
    return None


def a2q_acc_caps(acc_bits: int) -> tuple[int, int]:
    """(max positive, max |negative|) value a p-bit register can hold."""
    return 2 ** (acc_bits - 1) - 1, 2 ** (acc_bits - 1)


def a2q_l1_bound(weight_bits: int, acc_bits: int) -> float:
    """Largest ||w^q||_1 for overflow-free p-bit accumulation, the
    sign-agnostic (legacy A2Q) form; ``a2q_row_bounds`` gives the per-row
    sign-split bound that certification relies on."""
    return (2 ** (acc_bits - 1) - 1) / (2 ** (weight_bits - 1))


def a2q_row_bounds(
    wq: torch.Tensor,
    weight_bits: Optional[int] = None,
    *,
    act_qparams=None,
    act_bits: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Worst-case accumulator excursions per row of wq (..., K): (pos,
    neg), the largest positive value and negative magnitude any partial
    sum can reach over admissible activation codes (the frozen range when
    given, else |x^q| <= 2^(b-1) with b = weight_bits)."""
    rng = act_code_range(act_qparams, act_bits)
    if rng is None:
        if weight_bits is None:
            raise ValueError("need weight_bits or an activation range")
        mag = 2 ** (weight_bits - 1)
        qlo, qhi = -mag, mag
    else:
        qlo, qhi = rng
    w = wq.to(torch.float32)
    wp = torch.clamp(w, min=0.0).sum(dim=-1)
    wn = torch.clamp(-w, min=0.0).sum(dim=-1)
    pos = qhi * wp + (-qlo) * wn
    neg = (-qlo) * wp + qhi * wn
    return pos, neg


def _resolve_act_bits(act_qparams, act_bits) -> Optional[int]:
    if act_qparams is not None:
        return int(act_qparams.bits)
    return None if act_bits is None else int(act_bits)


def _over(num: float, t: torch.Tensor) -> torch.Tensor:
    """float32 num / t, rounded once as JAX divides (``num / t`` with a
    Python number is ``t.reciprocal() * num`` in torch: two roundings)."""
    return torch.div(torch.full_like(t, num), t)


def a2q_quantize_project(
    w: torch.Tensor,
    weight_bits: int,
    acc_bits: int,
    act_qparams=None,
    act_bits: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel quantize and accumulator projection of w (out, K).

    Returns (wq, scale): wq int32-carrier, scale (out,) float32, every
    row within the bound (the symmetric L1 form by default, the
    sign-split form against the frozen activation range when
    ``act_qparams`` / ``act_bits`` is given). Plain torch, no gradient.
    """
    act = _resolve_act_bits(act_qparams, act_bits)
    w = w.detach()
    _, qmax = qrange(weight_bits)
    amax = torch.clamp(w.abs().amax(dim=-1, keepdim=True), min=1e-8)
    # per-channel symmetric scale; times the float32 reciprocal, as XLA
    # compiles the JAX package's jitted division by the constant qmax
    scale = amax * (1.0 / qmax)
    wq = torch.clamp(torch.round(w / scale), -qmax, qmax)
    if act is None:
        bound = a2q_l1_bound(weight_bits, acc_bits)
        l1 = wq.abs().sum(dim=-1, keepdim=True)
        factor = torch.clamp(_over(bound, torch.clamp(l1, min=1.0)),
                             max=1.0)
    else:
        cap_pos, cap_neg = a2q_acc_caps(acc_bits)
        pos, neg = a2q_row_bounds(wq, act_bits=act)
        factor = torch.minimum(
            torch.clamp(_over(cap_pos, torch.clamp(pos, min=1.0)), max=1.0),
            _over(cap_neg, torch.clamp(neg, min=1.0)))[..., None]
    # truncation toward zero: sum |trunc(wq f)| <= f sum |wq| <= bound,
    # and the same contraction holds for the sign-split sums
    wq = torch.trunc(wq * factor).to(torch.int32)
    return wq, scale[..., 0]


def a2q_fake_quant(
    w: torch.Tensor,
    weight_bits: int,
    acc_bits: int,
    act_qparams=None,
    act_bits: Optional[int] = None,
) -> torch.Tensor:
    """QAT forward of A2Q weights: quantize, project and dequantize, with
    a straight-through gradient (the identity)."""
    wq, scale = a2q_quantize_project(w, weight_bits, acc_bits, act_qparams,
                                     act_bits)
    w_star = wq.to(torch.float32) * scale[:, None]
    return w + (w_star - w).detach()


def a2q_violations(
    wq: torch.Tensor,
    weight_bits: int,
    acc_bits: int,
    act_qparams=None,
    act_bits: Optional[int] = None,
) -> torch.Tensor:
    """Number of rows over the bound (0 after projection, by design); the
    sign-split condition with a frozen activation range, the one serving
    certification enforces."""
    bits = _resolve_act_bits(act_qparams, act_bits)
    if bits is None:
        l1 = wq.to(torch.int32).abs().sum(dim=-1, dtype=torch.int32)
        return (l1 > a2q_l1_bound(weight_bits, acc_bits)).sum()
    cap_pos, cap_neg = a2q_acc_caps(acc_bits)
    pos, neg = a2q_row_bounds(wq, act_bits=bits)
    return ((pos > cap_pos) | (neg > cap_neg)).sum()


def a2q_sparsity(wq: torch.Tensor) -> torch.Tensor:
    """Fraction of zero integers: A2Q's induced unstructured sparsity."""
    return (wq == 0).to(torch.float32).mean()
