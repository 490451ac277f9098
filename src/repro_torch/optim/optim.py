"""Optimizers from scratch: AdamW, SGD with momentum, schedules and the
global-norm gradient clip; torch port of ``repro.optim.optim``.

Functional, as in the JAX package: an optimizer is a pair (init, update)
over the port's parameter trees (``core/tree.py``: dicts and lists of
tensors), not a ``torch.optim`` object. ``update(grads, state, params)``
returns (new params, new state) and changes nothing in place. The state
mirrors the param tree leaf for leaf, in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Tree  # first moment (or momentum buffer)
    nu: Optional[Tree]  # second moment (None for SGD)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], tuple[Tree, OptState]]


# ---------------------------------------------------------------------------
# schedules: step (an int32 tensor) -> float32 learning rate
# ---------------------------------------------------------------------------


def linear_warmup(base_lr: float, warmup_steps: int) -> Callable:
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / max(warmup_steps, 1),
                           max=1.0)
        return base_lr * frac

    return fn


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> Callable:
    def fn(step):
        s = step.to(torch.float32)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup_steps, warm, cos)

    return fn


# ---------------------------------------------------------------------------
# gradient clipping
# ---------------------------------------------------------------------------


def global_norm(tree: Tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(
        torch.div(torch.full_like(norm, max_norm),
                  torch.clamp(norm, min=1e-9)), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm


def _lr_fn(lr: float | Callable) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _zeros(params: Tree) -> Tree:
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                          device=a.device), params)


def _step0(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(_step0(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        t = step.to(torch.float32)
        lr_t = lr_fn(step)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / bc1
            vh = v / bc2
            dp = mh / (torch.sqrt(vh) + eps)
            # decoupled weight decay on >=2-D leaves only (skip norms, bias)
            if p.ndim >= 2:
                dp = dp + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr_t * dp).to(p.dtype)
            return new_p, m, v

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_leaves(grads), tree_leaves(state.mu),
            tree_leaves(state.nu), tree_leaves(params))]
        return (tree_unflatten(params, [o[0] for o in out]),
                OptState(step, tree_unflatten(params, [o[1] for o in out]),
                         tree_unflatten(params, [o[2] for o in out])))

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


def sgd_momentum(
    lr: float | Callable = 1e-2,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(_step0(params), _zeros(params), None)

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = lr_fn(step)

        def upd(g, m, p):
            g = g.to(torch.float32)
            if weight_decay and p.ndim >= 2:
                g = g + weight_decay * p.to(torch.float32)
            m = momentum * m + g
            return (p.to(torch.float32) - lr_t * m).to(p.dtype), m

        out = [upd(g, m, p) for g, m, p in zip(
            tree_leaves(grads), tree_leaves(state.mu), tree_leaves(params))]
        return (tree_unflatten(params, [o[0] for o in out]),
                OptState(step, tree_unflatten(params, [o[1] for o in out]),
                         None))

    return Optimizer(init, update)
