"""Accumulator-aware fine-tuning, the "train" of train -> certify ->
serve; torch port of ``repro.runtime.qat``.

``a2q_finetune`` runs a model's float params through a short QAT loop in
which every named linear site executes ``core.a2q.a2q_fake_quant`` (the
``dispatch.a2q_qat`` context and the ``models.layers.lin`` hook), the
optimizer projects each channel after every step
(``optim.with_a2q_projection``), and the per-site overflow census runs as
a training signal through the monitor serving uses
(``dispatch.CensusMonitor``). One eager step function takes the place of
the JAX package's ``jax.jit``: the loss by autograd, then the optimizer's
functional update.

``quantize_and_certify`` is the handoff to serving: quantize the
fine-tuned params, enforce the bound exactly in the integer domain
(``core.certify.enforce_acc_bounds``) and emit the ``Certificate`` the
engine attaches to ``IntegerLinConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import certify, dispatch
from repro_torch.core.qtensor import quantize_tree
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.optim import Optimizer, adamw, with_a2q_projection


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """Knobs of the accumulator-aware fine-tuning loop.

    weight_bits / acc_bits / act_bits pin the (b, p) pair certified for;
    they must match the serving ``IntegerLinConfig`` for the certificate
    to cover the served widths. ``census_rows`` activation rows a site
    feed the census signal (0 turns it off); ``project_each_step``
    applies the A2Q+ projection after every update; ``min_dim`` skips
    tiny projections.
    """

    weight_bits: int = 8
    acc_bits: int = 16
    act_bits: int = 8
    lr: float = 1e-3
    census_rows: int = 4
    min_dim: int = 16
    project_each_step: bool = True


def _on(device, batch: dict) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def a2q_finetune(
    model: Any,
    params: Any,
    next_batch: Callable[[int], dict],
    steps: int,
    cfg: QATConfig = QATConfig(),
    optimizer: Optional[Optimizer] = None,
) -> tuple[Any, list[dict]]:
    """Fine-tune ``params`` under accumulator-aware fake quantization.

    ``model`` is a ``models.model.Model`` (``model.loss(params, batch)``
    on batch["tokens"] / batch["labels"]); ``next_batch(i)`` gives step
    i's batch (arrays or tensors, moved to the model's device). Returns
    (new params, history): each entry holds the step's loss and the
    drained per-site census (dots, events) and rates.
    """
    opt = optimizer or adamw(lr=cfg.lr, weight_decay=0.0)
    if cfg.project_each_step:
        opt = with_a2q_projection(opt, cfg.weight_bits, cfg.acc_bits,
                                  cfg.act_bits, cfg.min_dim)
    qat = dispatch.QATQuantConfig(
        weight_bits=cfg.weight_bits, acc_bits=cfg.acc_bits,
        act_bits=cfg.act_bits, min_dim=cfg.min_dim,
        census_rows=cfg.census_rows)
    mon = dispatch.CensusMonitor()
    opt_state = opt.init(params)

    def step_fn(p, s, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        loss = model.loss(tree_unflatten(p, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        p2, s2 = opt.update(tree_unflatten(p, grads), s,
                            tree_unflatten(p, [t.detach() for t in leaves]))
        return p2, s2, loss.detach()

    history: list[dict] = []
    with dispatch.a2q_qat(qat), dispatch.census_monitor(mon):
        for i in range(steps):
            params, opt_state, loss = step_fn(
                params, opt_state, _on(model.device, next_batch(i)))
            rates = mon.rates()
            history.append({"step": i, "loss": float(loss),
                            "census": mon.drain(), "census_rates": rates})
    return params, history


def quantize_and_certify(
    params: Any,
    acc_bits: int,
    act_bits: int = 8,
    weight_bits: int = 8,
    n_keep: Optional[int] = None,
    m: int = 16,
    min_size: int = 1 << 10,
    min_dim: int = 16,
    device=None,
) -> tuple[Any, certify.Certificate]:
    """Quantize, enforce the bound exactly, emit the certificate.

    The integer-domain enforcement follows QAT (requantization rounding
    can nudge a row over the bound; rows already inside pass through
    bit-exactly), so the certificate covers ``acc_bits`` by
    construction. The QTensors land on ``device`` (CUDA unless the caller
    asks for the CPU).
    """
    qparams = quantize_tree(params, bits=weight_bits, n_keep=n_keep, m=m,
                            min_size=min_size, min_dim=min_dim,
                            device=device)
    qparams = certify.enforce_acc_bounds(qparams, acc_bits, act_bits)
    cert = certify.certify_params(qparams, acc_bits, act_bits)
    return qparams, cert
