"""Uniform quantization primitives (paper section 2.1), torch port of
``repro.core.quant``: the integer range and the per-tensor QParams. The
activation-range calibrators are not ported yet."""

from __future__ import annotations

import dataclasses

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
