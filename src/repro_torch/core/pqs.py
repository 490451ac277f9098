"""PQS orchestration: config, quantized layers, and the P->Q / Q->P
schedules; torch port of ``repro.core.pqs``.

- ``PQSConfig``: the design space of paper section 5.2 (weight, activation
  and accumulator widths, N:M sparsity, accumulation policy, k_tile).
- QuantLinear, a functional linear layer (params and state in a dict):
  * ``quant_linear_train_fwd``: float32 matmul with the N:M mask and,
    during QAT, straight-through fake quantization of weights and
    activations;
  * ``quant_linear_int_fwd``: true integer dot products accumulated under
    the policy in an ``acc_bits`` register (``dispatch.pqs_dot``: the CUDA
    kernels on the card, their plain versions on the CPU);
  * ``quant_linear_census``: the overflow census of the same dots.
- The schedules: P->Q (float32 epochs with iterative pruning, then QAT)
  and Q->P (QAT throughout, the fake-quantized weights pruned), paper
  sections 4 and 5.1.

Gradients follow the JAX graph: the training forward differentiates
through the weight scale's ``amax`` and through the activation observer's
bounds into ``fake_quant``'s clip limits, neither detached, with
reductions that split a tie's gradient as JAX's do. The activation
observer counts its updates on the host (``EmaRange``), so a layer frozen
on the card has the CPU's quantization parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import dispatch, overflow
from repro_torch.core.pruning import iterative_nm_schedule, nm_prune_mask
from repro_torch.core.quant import (
    EmaRange,
    activation_qparams,
    fake_quant,
    quantize,
    weight_qparams,
)


@dataclasses.dataclass(frozen=True)
class PQSConfig:
    """Design-space point for PQS (paper section 5.2 sweeps all of these)."""

    weight_bits: int = 8
    act_bits: int = 8
    acc_bits: int = 16
    n_keep: int = 8  # keep n_keep of every m (sparsity = 1 - n_keep/m)
    m: int = 16
    policy: str = "sorted_tiled"  # inference accumulation policy
    k_tile: int = 256
    rounds: int = 2  # split/sort/pair rounds per sorting stage
    # training schedule: "pq" = prune-then-quantize (the paper's winner),
    # "qp" = quantize-then-prune baseline
    order: str = "pq"

    @property
    def sparsity(self) -> float:
        return 1.0 - self.n_keep / self.m

    def validate(self) -> None:
        assert 2 <= self.weight_bits <= 8 and 2 <= self.act_bits <= 8
        assert 8 <= self.acc_bits <= 30
        assert 0 < self.n_keep <= self.m
        assert self.policy in (
            "wide", "clip", "wrap", "sorted", "sorted_tiled",
            "sorted_tiled_seq",
        )
        assert self.order in ("pq", "qp")
        assert self.rounds >= 1


# ---------------------------------------------------------------------------
# QuantLinear: functional quantized linear layer
# ---------------------------------------------------------------------------


def quant_linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                      dtype=torch.float32) -> dict[str, Any]:
    """He-initialised params and PQS state for one linear layer, on the
    generator's device (the draws differ from the JAX package's keys;
    ``repro_torch.convert.papernet_layers_from_numpy`` carries JAX layers
    across instead)."""
    dev = gen.device
    w = torch.randn((out_dim, in_dim), generator=gen, dtype=dtype,
                    device=dev) * (2.0 / in_dim) ** 0.5
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {
        "w": w,
        "b": torch.zeros((out_dim,), dtype=dtype, device=dev),
        "mask": torch.ones((out_dim, in_dim), dtype=dtype, device=dev),
        "act_range": EmaRange(zero, zero),
    }


def quant_linear_train_fwd(
    params: dict[str, Any],
    x: torch.Tensor,
    cfg: PQSConfig,
    quantizing: bool,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Training forward: masked weights, and fake quantization during QAT.

    Returns (output, new_params); new_params carries the updated
    activation-range observer. In the float32 pruning phase
    (quantizing=False) this is a masked linear; during QAT weights and
    activations pass through the straight-through fake quantizer.
    """
    w = params["w"] * params["mask"]
    rng: EmaRange = params["act_range"].update(x)
    if quantizing:
        w = fake_quant(w, weight_qparams(w, cfg.weight_bits))
        lo, hi = rng.bounds()
        x = fake_quant(x, activation_qparams(lo, hi, cfg.act_bits))
    y = x @ w.T + params["b"]
    new_params = dict(params)
    new_params["act_range"] = rng
    return y, new_params


@torch.no_grad()
def quant_linear_freeze(params: dict[str, Any], cfg: PQSConfig
                        ) -> dict[str, Any]:
    """Trained float32 params -> the deployable integer form {wq, w_qp,
    x_qp, b}: wq the N:M-masked quantized weight (int32 carrier), the
    bias kept in float32 and added in the wide domain (the narrow
    register holds the dot product itself, Eq. 4)."""
    w = params["w"] * params["mask"]
    w_qp = weight_qparams(w, cfg.weight_bits)
    wq = quantize(w, w_qp)
    lo, hi = params["act_range"].bounds()
    x_qp = activation_qparams(lo, hi, cfg.act_bits)
    return {"wq": wq, "w_qp": w_qp, "x_qp": x_qp, "b": params["b"]}


@torch.no_grad()
def quant_linear_int_fwd(
    frozen: dict[str, Any],
    x: torch.Tensor,
    cfg: PQSConfig,
    batch_chunk: Optional[int] = 128,
) -> torch.Tensor:
    """Integer inference with simulated narrow accumulation (Eq. 3, 4).

    x (float32) is quantized with the calibrated activation params, the
    integer dot accumulated under cfg.policy at cfg.acc_bits, the
    activation-offset correction (a weight-only constant) applied in the
    wide domain, and the result dequantized. The codes go to
    ``pqs_dot`` as int8 (``validate`` bounds both widths by 8 bits), so
    the kernels read them without a range check: the CUDA kernels for
    tensors on the card, the plain versions on the CPU.
    """
    wq, w_qp, x_qp = frozen["wq"], frozen["w_qp"], frozen["x_qp"]
    xq = quantize(x, x_qp)
    lead = x.shape[:-1]
    xq2 = xq.reshape(-1, xq.shape[-1]).to(torch.int8)
    z = dispatch.pqs_dot(
        xq2, wq.to(torch.int8), acc_bits=cfg.acc_bits, policy=cfg.policy,
        k_tile=cfg.k_tile, rounds=cfg.rounds, batch_chunk=batch_chunk)
    # offset correction: o_x * sum_i w_i^q per output neuron (wide domain)
    corr = x_qp.offset.to(torch.int32) * wq.sum(dim=-1, dtype=torch.int32)
    z = z - corr[None, :]
    zf = z.to(torch.float32) * (w_qp.scale * x_qp.scale)
    zf = zf + frozen["b"][None, :]
    return zf.reshape(*lead, -1)


@torch.no_grad()
def quant_linear_census(frozen: dict[str, Any], x: torch.Tensor,
                        cfg: PQSConfig) -> overflow.Census:
    """Overflow census of this layer on a batch (the analysis path), by
    the census of ``core.overflow`` on the operands' device."""
    xq = quantize(x, frozen["x_qp"]).reshape(-1, x.shape[-1])
    return overflow.matmul_census(frozen["wq"], xq, cfg.acc_bits)


# ---------------------------------------------------------------------------
# Training schedules (paper sections 4, 5.0.2, 5.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase:
    """One epoch's directives for ``train_papernet``'s schedule loop."""

    epoch: int
    quantizing: bool  # QAT fake-quant active this epoch?
    n_keep: Optional[int]  # if set, re-prune to keep n_keep of every m


def pq_schedule(cfg: PQSConfig, total_epochs: int, prune_every: int,
                fp32_epochs: int) -> list[Phase]:
    """P->Q: float32 training with iterative pruning, then QAT on the
    survivors (paper section 5.1: e.g. 180 float32 epochs pruning every
    10, then 20 of QAT)."""
    prunes = dict(iterative_nm_schedule(
        max(fp32_epochs - 1, 1), prune_every, cfg.m, cfg.sparsity))
    return [Phase(e, quantizing=(e >= fp32_epochs), n_keep=prunes.get(e))
            for e in range(total_epochs)]


def qp_schedule(cfg: PQSConfig, total_epochs: int, prune_every: int
                ) -> list[Phase]:
    """Q->P: QAT for all epochs, pruning the (fake-)quantized weights."""
    prunes = dict(iterative_nm_schedule(total_epochs, prune_every, cfg.m,
                                        cfg.sparsity))
    return [Phase(e, quantizing=True, n_keep=prunes.get(e))
            for e in range(total_epochs)]


def build_schedule(cfg: PQSConfig, total_epochs: int, prune_every: int = 10,
                   fp32_frac: float = 0.9) -> list[Phase]:
    cfg.validate()
    if cfg.order == "pq":
        return pq_schedule(cfg, total_epochs, prune_every,
                           int(total_epochs * fp32_frac))
    return qp_schedule(cfg, total_epochs, prune_every)


@torch.no_grad()
def apply_prune_phase(params: dict[str, Any], phase: Phase, cfg: PQSConfig,
                      quantized_signal: bool) -> dict[str, Any]:
    """Re-prune a layer per the phase directive. ``quantized_signal``
    picks the pruning signal: the float32 master weights (P->Q) or their
    fake-quantized image (Q->P), the comparison at the heart of paper
    section 4."""
    if phase.n_keep is None:
        return params
    w = params["w"]
    if quantized_signal:
        w = fake_quant(w, weight_qparams(w, cfg.weight_bits))
    new = dict(params)
    new["mask"] = nm_prune_mask(w, phase.n_keep, cfg.m)
    return new
