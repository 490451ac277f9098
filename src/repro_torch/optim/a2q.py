"""A2Q+-style per-channel weight-norm projection as an optimizer
transform; torch port of ``repro.optim.a2q``.

``core.a2q`` enforces the accumulator bound in the integer domain; this
module is the training-side complement: after every optimizer step each
output channel of every large float weight is softly projected toward the
scale-invariant shape condition

    ||w||_1 / ||w||_inf <= ratio := (2^(p-1) - 1) / 2^(b-1) / qmax_w,

what per-channel max-calibrated quantization turns the integer L1 bound
into. Iterates near the certifiable region make the STE projection of
``a2q_fake_quant`` truncate little. The projection is a pre-conditioner,
not the guarantee: that is ``core.certify.enforce_acc_bounds`` and the
certification after training.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import tree_map
from repro_torch.optim.optim import Optimizer


def a2q_l1_ratio(weight_bits: int = 8, acc_bits: int = 16,
                 act_bits: int = 8) -> float:
    """Float-domain shape cap ||w||_1 / ||w||_inf of certifiable rows: a
    quantized row with ||w^q||_1 <= (2^(p-1) - 1) / 2^(b-1) keeps both
    sign-split excursions inside the p-bit caps for any b-bit activation
    code, and max calibration gives ||w^q||_1 ~= ||w||_1 qmax_w /
    ||w||_inf."""
    cap_pos = 2 ** (acc_bits - 1) - 1
    qmax_w = 2 ** (weight_bits - 1) - 1
    return cap_pos / (2 ** (act_bits - 1)) / qmax_w


def _soft_threshold_rows(v: torch.Tensor, ratio: float, iters: int = 25,
                         outer: int = 2) -> torch.Tensor:
    """Project rows (C, K) toward ||v||_1 <= ratio ||v||_inf.

    Per row: bisect the soft threshold lam so that sum(relu(|v| - lam))
    <= ratio ||v||_inf and apply sign(v) relu(|v| - lam). Thresholding
    shrinks the max too, so a couple of outer sweeps re-anchor the
    target; rows already inside pass through bit-exactly (lam = 0).
    """
    for _ in range(outer):
        a = v.abs()
        amax = a.amax(dim=-1, keepdim=True)
        target = ratio * amax
        need = a.sum(dim=-1, keepdim=True) > target
        lo = torch.zeros_like(amax)
        hi = amax
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            s = torch.clamp(a - mid, min=0.0).sum(dim=-1, keepdim=True)
            over = s > target
            lo = torch.where(over, mid, lo)
            hi = torch.where(over, hi, mid)
        lam = torch.where(need, hi, torch.zeros_like(hi))
        v = torch.sign(v) * torch.clamp(a - lam, min=0.0)
    return v


@torch.no_grad()
def a2q_project_tree(params: Any, weight_bits: int = 8, acc_bits: int = 16,
                     act_bits: int = 8, min_dim: int = 16) -> Any:
    """Shape-project every large float matrix of a tree, channelwise: the
    leaves QAT fake-quantizes and quantization converts (float, >= 2
    dims, min of the last two >= ``min_dim``); the rest pass through.
    Output channels are the LAST axis ((..., in, out)), as ``core.a2q``'s
    per-(out)-channel rows."""
    ratio = a2q_l1_ratio(weight_bits, acc_bits, act_bits)

    def conv(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.ndim < 2 or not leaf.is_floating_point():
            return leaf
        if min(leaf.shape[-2:]) < min_dim:
            return leaf
        wt = leaf.to(torch.float32).transpose(-1, -2)
        rows = wt.reshape(-1, wt.shape[-1])
        proj = _soft_threshold_rows(rows, ratio)
        return proj.reshape(wt.shape).transpose(-1, -2).to(leaf.dtype)

    return tree_map(conv, params)


def with_a2q_projection(opt: Optimizer, weight_bits: int = 8,
                        acc_bits: int = 16, act_bits: int = 8,
                        min_dim: int = 16) -> Optimizer:
    """Wrap an optimizer so that every update lands near the certifiable
    region: the inner update first (any ``Optimizer``), then the
    per-channel projection of the new params. The state is untouched:
    the moments track the unprojected dynamics, as A2Q+ trains through
    its normalisation."""

    def update(grads, state, params):
        new_params, new_state = opt.update(grads, state, params)
        return a2q_project_tree(new_params, weight_bits, acc_bits, act_bits,
                                min_dim), new_state

    return Optimizer(opt.init, update)
