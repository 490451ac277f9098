"""Unified accumulation-policy execution, torch port of
``repro.core.dispatch`` for one device and dense storage.

``pqs_dot(x, w, ...)`` runs any of the six policies on one of two
backends, bit-identical to each other:

  - ``torch`` — the plain version (``core.overflow`` on explicit partial
                products), on the CPU or the card;
  - ``cuda``  — the hand-written CUDA kernels (``kernels/ops.py``).

The default follows the operands' device: ``cuda`` for CUDA tensors,
``torch`` for CPU tensors. K is zero-padded here by one rule for both
backends, so order-sensitive policies see the same permutation domain.

``qtensor_dot`` + ``integer_lin`` put serving on this path: inside the
context every ``models.layers.lin`` whose weight is a QTensor runs as an
integer dot under the configured policy.

Not ported yet, and refused with ``NotImplementedError``: the overflow
census (``with_census``, ``census_monitor``), meshes and K-sharding
(``mesh``, ``k_shards``, ``k_axis``, ``defer_combine``) and compressed
N:M storage (``storage="nm"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from repro_torch.core.quant import qrange
from repro_torch.kernels import ops
from repro_torch.kernels.sorted_matmul import policy_accumulate_ref

POLICIES = ops.POLICIES
BACKENDS = ("torch", "cuda")
STORAGES = ("dense",)


def default_backend(x: torch.Tensor) -> str:
    """``cuda`` (the kernels) for CUDA tensors, ``torch`` otherwise."""
    return "cuda" if x.is_cuda else "torch"


def _validate(policy: str, backend: Optional[str], acc_bits: int,
              k_tile: int, storage: str = "dense") -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if storage == "nm":
        raise NotImplementedError(
            "storage='nm' (compressed N:M weights) waits for the N:M "
            "kernels of a later slice of the port")
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; expected {STORAGES}")
    if not 2 <= acc_bits <= 30:
        raise ValueError(f"acc_bits={acc_bits} outside the int32-carrier "
                         "range [2, 30]")
    if policy in ("sorted_tiled", "sorted_tiled_seq") and (
        k_tile <= 0 or k_tile & (k_tile - 1)
    ):
        raise ValueError(f"k_tile must be a power of 2, got {k_tile}")


def _local_dot(
    x2: torch.Tensor,  # (M, Kp), K already padded by the shared rule
    w: torch.Tensor,  # (N, Kp)
    *,
    acc_bits: int,
    policy: str,
    k_tile: int,
    rounds: int,
    backend: str,
    batch_chunk: Optional[int],
    certified: bool = False,
) -> torch.Tensor:
    """Single-device policy matmul on pre-padded operands.

    certified=True: a proof says no partial sum reaches the acc_bits
    caps, so both backends accumulate ``wide`` (bit-identical to the
    narrow result by the proof).
    """
    if backend == "torch":
        return policy_accumulate_ref(
            x2, w, policy="wide" if certified else policy,
            acc_bits=acc_bits, k_tile=k_tile, rounds=rounds,
            batch_chunk=batch_chunk)
    m = x2.shape[0]
    chunk = m if (batch_chunk is None or batch_chunk >= m) else batch_chunk
    outs = [
        ops.policy_matmul(x2[i : i + chunk], w, policy=policy,
                          acc_bits=acc_bits, k_tile=k_tile, rounds=rounds,
                          census=not certified)
        for i in range(0, m, max(chunk, 1))
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def pqs_dot(
    x: torch.Tensor,  # (..., K) integer carrier (int8, or int32 of int8)
    w: torch.Tensor,  # (N, K) integer carrier; rows = output channels
    *,
    acc_bits: int = 16,
    policy: str = "wide",
    k_tile: int = 256,
    rounds: int = 1,
    backend: Optional[str] = None,
    batch_chunk: Optional[int] = None,
    with_census: bool = False,
    mesh=None,
    k_shards: Optional[int] = None,
    k_axis: Optional[str] = None,
    storage: str = "dense",
    certified: bool = False,
    defer_combine: bool = False,
) -> torch.Tensor:
    """Quantized dot products with simulated narrow accumulation.

    Returns (..., N) int32, each element a dot product accumulated into
    an acc_bits register under ``policy``. Any M/N/K: padding and batch
    chunking happen here. ``backend="cuda"`` on CPU tensors raises.
    """
    _validate(policy, backend, acc_bits, k_tile, storage)
    if with_census:
        raise NotImplementedError(
            "the overflow census is not ported yet (with_census=True)")
    if mesh is not None or k_axis is not None or defer_combine or (
        k_shards is not None and int(k_shards) != 1
    ):
        raise NotImplementedError(
            "meshes and K-sharded accumulation (mesh=, k_shards=, k_axis=, "
            "defer_combine=) are not ported yet")
    backend = backend or default_backend(x)
    if backend == "cuda" and not (x.is_cuda and w.is_cuda):
        raise ValueError("backend='cuda' needs CUDA tensors; CPU tensors "
                         "take backend='torch'")
    if x.shape[-1] != w.shape[-1]:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} vs "
                         f"{tuple(w.shape)}")
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[0]
    x2 = x.reshape(-1, k)
    # one K-padding rule for both backends: order-sensitive policies must
    # see the same (padded) permutation domain to be bit-identical
    kp = ops.padded_k(k, policy, k_tile)
    if kp != k:
        x2 = ops._pad_to(x2, kp, 1)
        w = ops._pad_to(w, kp, 1)
    out = _local_dot(x2, w, acc_bits=acc_bits, policy=policy,
                     k_tile=k_tile, rounds=rounds, backend=backend,
                     batch_chunk=batch_chunk, certified=certified)
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# integer execution of QTensor projections (serving path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IntegerLinConfig:
    """How ``models.layers.lin`` executes QTensor weights.

    The defaults are the serving default of the JAX package: the paper's
    tiled sort (``sorted_tiled_seq``) at a 16-bit register, k_tile 256.
    ``use_static_acts`` picks a QTensor's calibrated ``act_qparams`` over
    the dynamic per-call absmax when it carries them. ``site_policies`` /
    ``site_acc_bits`` are per-site overrides, ((site, value), ...).
    """

    policy: str = "sorted_tiled_seq"
    acc_bits: int = 16
    k_tile: int = 256
    rounds: int = 1
    act_bits: int = 8
    backend: Optional[str] = None  # None = by the operands' device
    use_static_acts: bool = True
    site_policies: tuple = ()
    site_acc_bits: tuple = ()

    def policy_for(self, site: Optional[str]) -> str:
        return dict(self.site_policies).get(site, self.policy)

    def acc_bits_for(self, site: Optional[str]) -> int:
        return dict(self.site_acc_bits).get(site, self.acc_bits)


_INT_LIN: list[IntegerLinConfig] = []


def integer_lin_config() -> Optional[IntegerLinConfig]:
    return _INT_LIN[-1] if _INT_LIN else None


@contextlib.contextmanager
def integer_lin(cfg: Optional[IntegerLinConfig] = None, **kw):
    """Run QTensor projections as true integer dot products inside the
    context (``lin(x, QTensor)`` -> ``qtensor_dot``)."""
    _INT_LIN.append(cfg or IntegerLinConfig(**kw))
    try:
        yield _INT_LIN[-1]
    finally:
        _INT_LIN.pop()


def qtensor_dot(
    x: torch.Tensor, qt, cfg: IntegerLinConfig, site: Optional[str] = None
) -> torch.Tensor:
    """x (..., in) float @ QTensor (in, out) as an integer PQS dot.

    Activations are quantized per tensor: with the QTensor's static
    ``act_qparams`` when present (and ``cfg.use_static_acts``), else
    dynamically at act_bits from the absmax over the WHOLE tensor, every
    row included. The dynamic scale is computed in the activation dtype
    and only then cast to f32, as the JAX package does, so a bf16 step
    uses the bf16-rounded scale. The output is rescaled by the activation
    scale times the per-channel weight scales, then cast to x.dtype.
    """
    aq = qt.act_qparams
    static = cfg.use_static_acts and aq is not None
    if static:
        qmin, qmax = qrange(aq.bits)
        s_x = aq.scale.to(torch.float32)
        xq = torch.clamp(torch.round(x.to(torch.float32) / s_x) + aq.offset,
                         qmin, qmax)
        act_bits = aq.bits
    else:
        qmax = 2 ** (cfg.act_bits - 1) - 1
        qmin = -qmax - 1
        # the floor is made on the device (no host copy, no sync) and in
        # x.dtype, so the max compares in the activation dtype as JAX does
        amax = torch.maximum(x.abs().amax(),
                             torch.full((), 1e-8, dtype=x.dtype,
                                        device=x.device))
        s_x = (amax / qmax).to(torch.float32)
        xq = torch.clamp(torch.round(x.to(torch.float32) / s_x), qmin, qmax)
        act_bits = cfg.act_bits
    xq = xq.to(torch.int8 if act_bits <= 8 else torch.int32)
    z = pqs_dot(xq, qt.values_t, acc_bits=cfg.acc_bits_for(site),
                policy=cfg.policy_for(site), k_tile=cfg.k_tile,
                rounds=cfg.rounds, backend=cfg.backend)
    if static and not aq.symmetric:
        z = z - qt.act_corr  # Eq. (3) offset correction, frozen per weight
    zf = z.to(torch.float32) * (s_x * qt.scale)
    return zf.to(x.dtype)
