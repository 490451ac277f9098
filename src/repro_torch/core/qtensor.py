"""QTensor: int8 N:M-pruned weight carrier, torch port of
``repro.core.qtensor`` (dense storage; the compressed ``SparseQTensor``
waits for the N:M kernels).

The public layout is the JAX package's: ``values`` (in, out) int8, the
layout of the float weight it replaces. The integer dot consumes the
weight as (out, in) rows, so each QTensor also keeps a contiguous
``values_t`` copy, made once when the QTensor is built instead of a
transpose and copy on every call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.pruning import nm_prune_mask
from repro_torch.core.quant import QParams, qrange
from repro_torch.core.tree import tree_map


@dataclasses.dataclass
class QTensor:
    """Per-output-channel symmetric int8 weight + f32 scale.

    values: (..., in, out) int8; scale: (..., out) f32.
    act_qparams: optional calibrated static input-activation QParams.
    act_corr: with asymmetric act_qparams, the Eq. (3) correction
        o_x * sum_k w_k^q per output channel (int32).
    values_t: (..., out, in) contiguous int8 copy of ``values``.
    """

    values: torch.Tensor
    scale: torch.Tensor
    act_qparams: Optional[QParams] = None
    act_corr: Optional[torch.Tensor] = None
    values_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.values_t is None:
            self.values_t = self.values.transpose(-1, -2).contiguous()

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.values.to(torch.float32) * self.scale).to(dtype)


def quantize_weight(
    w: torch.Tensor,
    bits: int = 8,
    n_keep: Optional[int] = None,
    m: int = 16,
) -> QTensor:
    """Symmetric per-column quantization with optional N:M pruning.

    w: (in, out) on any device (the result stays there). N:M groups run
    along the contraction (in) axis.
    """
    w = w.to(torch.float32)
    if n_keep is not None:
        w = w * nm_prune_mask(w.T, n_keep, m).T
    _, qmax = qrange(bits)
    amax = torch.clamp_min(w.abs().amax(dim=0), 1e-8)  # (out,)
    scale = amax / qmax
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return QTensor(q, scale.to(torch.float32))


def _quantize_stacked(leaf, bits, n_keep, m):
    """quantize_weight over the leading axes of a (..., in, out) leaf."""
    if leaf.ndim == 2:
        return quantize_weight(leaf, bits, n_keep, m)
    parts = [_quantize_stacked(a, bits, n_keep, m) for a in leaf]
    return QTensor(torch.stack([p.values for p in parts]),
                   torch.stack([p.scale for p in parts]))


def is_qtensor(x: Any) -> bool:
    return isinstance(x, QTensor)


def asarray(w: Any, dtype) -> torch.Tensor:
    """Uniform accessor used by every matmul of the model."""
    if isinstance(w, QTensor):
        return w.dequant(dtype)
    return w.to(dtype)


def quantize_tree(
    params: Any,
    bits: int = 8,
    n_keep: Optional[int] = None,
    m: int = 16,
    min_size: int = 1 << 16,
    min_dim: int = 128,
    device=None,
) -> Any:
    """Replace every large >=2-D float leaf with a QTensor on ``device``
    (CUDA unless the caller asks for the CPU).

    The skip rules are the JAX package's, applied to each leaf as it is
    given: leaves under ``min_size`` elements or with a trailing dim under
    ``min_dim`` stay float, and a leaf whose in dim is not a multiple of
    ``m`` is quantized without pruning. The port keeps one leaf per layer
    where the JAX package stacks (L, in, out), so ``min_size`` counts one
    layer's matrix here.
    """
    device = resolve_device(device)

    def conv(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf  # QTensors and plain values pass through
        leaf = leaf.to(device)
        if leaf.ndim < 2 or leaf.numel() < min_size:
            return leaf
        if min(leaf.shape[-2:]) < min_dim or not leaf.is_floating_point():
            return leaf
        keep = n_keep if leaf.shape[-2] % m == 0 else None
        return _quantize_stacked(leaf, bits, keep, m)

    return tree_map(conv, params)
