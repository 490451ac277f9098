"""Unified accumulation-policy execution, torch port of
``repro.core.dispatch`` for one device, dense and N:M compressed storage.

``pqs_dot(x, w, ...)`` runs any of the six policies on one of two
backends, bit-identical to each other:

  - ``torch`` — the plain version (``core.overflow`` on explicit partial
                products), on the CPU or the card;
  - ``cuda``  — the hand-written CUDA kernels (``kernels/ops.py``).

The default follows the operands' device: ``cuda`` for CUDA tensors,
``torch`` for CPU tensors. K is zero-padded by one rule for both
backends (``ops.padded_k``), so order-sensitive policies see the same
permutation domain: here for ``torch``, in ``ops.policy_matmul`` for
``cuda``, whose global-sort kernels mask the padding instead.

``storage="nm"`` takes the weight compressed (a ``SparseQTensor`` or a
``(values, indices)`` pair with ``m_group=``): the ``torch`` backend
decompresses it and runs the dense plain version, the ``cuda`` backend
runs the policy on the slabs (``kernels.ops.nm_policy_matmul``: ``nm_impl``
picks the gather or the expand kernels, and ``sort_impl`` the one-pass or
two-pass kernels of the global-sort policies). Both are bit-identical to
the dense path on the decompressed weight.

``with_census=True`` also returns the natural-order overflow census
(``core.overflow.census``) of the same operands: of the dense partial
products, or of the kept-only products on compressed storage. It is
plain torch on the operands' device, whatever the backend, taken over
M-chunks under ``_CENSUS_BUDGET``.

``qtensor_dot`` + ``integer_lin`` put serving on this path: inside the
context every ``models.layers.lin`` whose weight is a QTensor or a
SparseQTensor runs as an integer dot under the configured policy.
``census_monitor`` makes every named site report its census counts to a
``CensusMonitor`` (the serving engine's ``CensusWatch`` reads it), and
``calibration`` makes ``lin`` report each input's range to an
``ActCalibrator``. A site whose ``IntegerLinConfig.certificate`` covers
it (``core.certify``) runs census-free and reports nothing.

``a2q_qat`` is the training side: inside it every named ``lin`` whose
weight is still a float matrix runs ``a2q_qat_lin`` (A2Q fake
quantization under a straight-through estimator, and the census as a
training signal to the active monitor).

Not ported yet, and refused with ``NotImplementedError``: meshes and
K-sharding (``mesh``, ``k_shards``, ``k_axis``, ``defer_combine``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.a2q import a2q_fake_quant, a2q_quantize_project
from repro_torch.core.overflow import (
    Census,
    census,
    nm_partial_products,
    partial_products,
)
from repro_torch.core.pruning import nm_decompress
from repro_torch.core.qtensor import SparseQTensor
from repro_torch.core.quant import qrange
from repro_torch.kernels import ops
from repro_torch.kernels.sorted_matmul import policy_accumulate_ref

POLICIES = ops.POLICIES
BACKENDS = ("torch", "cuda")
STORAGES = ("dense", "nm")

# Cap on the device-memory tile-sum + permutation statistic of the
# two-pass sorted_tiled kernels (per M row 2 * 4 * N * K/k_tile bytes);
# pqs_dot chunks M to stay under it. The JAX package's value.
_SORT_STATS_BUDGET = 256 * 1024 * 1024

# Cap on the int32 partial-product cube of one census chunk (4 bytes a
# product; its running sum takes as much again). A 4 x 32 prefill cohort
# would otherwise build a 7.0 GB cube at w_gate (8960 x 1536) and the
# same again for its running sum; a qwen2-1.5b decode row is 55 MB
# there, so 4 decode rows stay one chunk. Where one row's cube is past it
# (qwen3-32b's untied head: 151936 x 5120, 3.1 GB) N is chunked too.
# Chunking is exact: the counts are per dot and sum over chunks.
_CENSUS_BUDGET = 256 * 1024 * 1024


def default_backend(x: torch.Tensor) -> str:
    """``cuda`` (the kernels) for CUDA tensors, ``torch`` otherwise."""
    return "cuda" if x.is_cuda else "torch"


def _validate(policy: str, backend: Optional[str], acc_bits: int,
              k_tile: int, storage: str = "dense") -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected {POLICIES}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; expected {STORAGES}")
    if not 2 <= acc_bits <= 30:
        raise ValueError(f"acc_bits={acc_bits} outside the int32-carrier "
                         "range [2, 30]")
    if policy in ("sorted_tiled", "sorted_tiled_seq") and (
        k_tile <= 0 or k_tile & (k_tile - 1)
    ):
        raise ValueError(f"k_tile must be a power of 2, got {k_tile}")


def _unpack_nm(w: Any, m_group: Optional[int]):
    """(values, indices, m_group, logical K) of a storage="nm" weight: a
    ``SparseQTensor`` (m_group and k_dim ride along) or a bare
    ``(values, indices)`` pair with an explicit ``m_group``."""
    if isinstance(w, SparseQTensor):
        if w.values.ndim != 3:
            raise ValueError(
                "pqs_dot needs an unstacked (out, G, n_keep) SparseQTensor; "
                f"got values {tuple(w.values.shape)} (one layer at a time)")
        return w.values, w.indices, w.m_group, w.k_dim
    if isinstance(w, (tuple, list)) and len(w) == 2:
        values, indices = w
        if m_group is None:
            raise ValueError("storage='nm' with a bare (values, indices) "
                             "pair needs an explicit m_group=")
        if values.ndim != 3 or values.shape != indices.shape:
            raise ValueError(f"expected matching (N, G, n_keep) slabs, got "
                             f"{tuple(values.shape)} / "
                             f"{tuple(indices.shape)}")
        return values, indices, m_group, values.shape[1] * m_group
    raise ValueError("storage='nm' expects w to be a SparseQTensor or a "
                     f"(values, indices) pair, got {type(w).__name__}")


def _local_dot(
    x2: torch.Tensor,  # (M, K); padded to Kp by the shared rule for torch
    w: Any,  # (N, K) dense, or the (values, indices) compressed slabs
    *,
    acc_bits: int,
    policy: str,
    k_tile: int,
    rounds: int,
    backend: str,
    batch_chunk: Optional[int],
    certified: bool = False,
    m_group: Optional[int] = None,
    nm_impl: Optional[str] = None,
    sort_impl: str = "auto",
) -> torch.Tensor:
    """Single-device policy matmul. The ``torch`` backend takes operands
    pre-padded to the policy's K; ``cuda`` pads (or masks) in
    ``ops.policy_matmul``.

    Compressed slabs (``m_group`` given): the ``torch`` backend
    decompresses them to the dense plain version, padded to the Kp the
    dense path would use (zero columns are inert); ``cuda`` runs
    ``ops.nm_policy_matmul`` on the slabs.

    certified=True: a proof says no partial sum reaches the acc_bits
    caps, so both backends accumulate ``wide`` (bit-identical to the
    narrow result by the proof).
    """
    if backend == "torch":
        if m_group is not None:
            w = ops._pad_to(nm_decompress(w[0].to(torch.int32), w[1],
                                          m_group), x2.shape[1], 1)
        return policy_accumulate_ref(
            x2, w, policy="wide" if certified else policy,
            acc_bits=acc_bits, k_tile=k_tile, rounds=rounds,
            batch_chunk=batch_chunk)
    m = x2.shape[0]
    chunk = m if (batch_chunk is None or batch_chunk >= m) else batch_chunk
    if m_group is not None:
        def dot(xc):
            return ops.nm_policy_matmul(
                xc, w[0], w[1], m_group=m_group, policy=policy,
                acc_bits=acc_bits, k_tile=k_tile, rounds=rounds,
                sort_impl=sort_impl, nm_impl=nm_impl, census=not certified)
    else:
        def dot(xc):
            return ops.policy_matmul(
                xc, w, policy=policy, acc_bits=acc_bits, k_tile=k_tile,
                rounds=rounds, sort_impl=sort_impl, census=not certified)
    outs = [dot(x2[i : i + chunk]) for i in range(0, m, max(chunk, 1))]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _merge_census(tot: Optional[Census], c: Census) -> Census:
    return c if tot is None else Census(*(a + b for a, b in zip(tot, c)))


def _census(x2: torch.Tensor, w: Any, acc_bits: int,
            m_group: Optional[int]) -> Census:
    """Natural-order census of x2 (M, K) against a dense (N, K) weight or
    the kept-only products of (values, indices) slabs, on the operands'
    device, in chunks of at most ``_CENSUS_BUDGET`` bytes of products: of
    M rows, and of N outputs where one row's products are past it."""
    if m_group is None:
        n, width = w.shape
    else:
        n, g, n_keep = w[0].shape
        width = g * n_keep
    row_bytes = 4 * max(width, 1)
    rows = max(_CENSUS_BUDGET // (n * row_bytes), 1)
    cols = n if rows > 1 else max(min(_CENSUS_BUDGET // row_bytes, n), 1)
    tot = None
    for i in range(0, max(x2.shape[0], 1), rows):
        xc = x2[i : i + rows]
        for j in range(0, n, cols):
            prods = (partial_products(w[j : j + cols], xc) if m_group is None
                     else nm_partial_products(w[0][j : j + cols],
                                              w[1][j : j + cols], xc,
                                              m_group))
            tot = _merge_census(tot, census(prods, acc_bits))
    return tot


def pqs_dot(
    x: torch.Tensor,  # (..., K) integer carrier (int8, or int32 of int8)
    w: Any,  # (N, K) integer carrier, rows = output channels; or N:M slabs
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
    m_group: Optional[int] = None,
    nm_impl: Optional[str] = None,
    certified: bool = False,
    defer_combine: bool = False,
    sort_impl: str = "auto",
) -> torch.Tensor:
    """Quantized dot products with simulated narrow accumulation.

    Returns (..., N) int32, each element a dot product accumulated into
    an acc_bits register under ``policy``, or ``(out, Census)`` with
    ``with_census=True`` (the counts summed over every dot). Any M/N/K:
    padding and batch chunking happen here. ``backend="cuda"`` on CPU
    tensors raises.

    ``certified=True`` declares that a ``core.certify`` proof covers
    these operands at acc_bits: both backends accumulate ``wide``,
    bit-identical to the narrow result by the proof. A certified dot has
    no census, so it excludes ``with_census``.

    ``sort_impl`` picks the CUDA kernels of the global-sort policies, on
    dense and on compressed storage: ``auto`` (the one-pass kernel up to
    ``ops.MAX_RESIDENT_K`` of padded K, the two-pass pipeline above),
    ``onepass`` or ``twopass``; the result is the same either way.

    ``storage="nm"``: ``w`` is a ``SparseQTensor`` or a ``(values,
    indices)`` pair plus ``m_group``; x carries the logical K or the
    padded G * m_group. ``nm_impl`` (``auto``, ``expand``, ``gather``)
    picks the CUDA kernel; the result is the same either way.
    """
    _validate(policy, backend, acc_bits, k_tile, storage)
    if nm_impl is not None:
        if storage != "nm":
            raise ValueError("nm_impl= is only meaningful with storage='nm'")
        if nm_impl not in ops.NM_IMPLS:
            raise ValueError(
                f"nm_impl must be one of {ops.NM_IMPLS}, got {nm_impl!r}")
    if certified and with_census:
        raise ValueError(
            "certified=True removes the census from the path entirely; "
            "with_census=True contradicts it")
    if mesh is not None or k_axis is not None or defer_combine or (
        k_shards is not None and int(k_shards) != 1
    ):
        raise NotImplementedError(
            "meshes and K-sharded accumulation (mesh=, k_shards=, k_axis=, "
            "defer_combine=) are not ported yet")
    backend = backend or default_backend(x)
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()  # the kernels take dense rows
    if storage == "nm":
        values, indices, m_group, k_logical = _unpack_nm(w, m_group)
        k_dense = values.shape[1] * m_group
        if k not in (k_logical, k_dense):
            raise ValueError(
                f"contraction mismatch: x has K={k} but the compressed "
                f"weights cover {k_logical} (logical) / {k_dense} (padded)")
        if policy in ("sorted_tiled", "sorted_tiled_seq") and (
                k_tile % m_group):
            raise ValueError(
                f"tiled policies on storage='nm' need k_tile % m_group == "
                f"0 (tile boundaries must align with the compressed "
                f"groups); got k_tile={k_tile}, m_group={m_group}")
        x2 = ops._pad_to(x2, k_dense, 1)  # tail K -> whole groups
        kp = ops.padded_k(k_dense, policy, k_tile)
        if backend == "torch":
            # the plain version pads the dense weight, as the dense path
            x2 = ops._pad_to(x2, kp, 1)
        w, n, nm = (values, indices), values.shape[0], m_group
        on_card = x.is_cuda and values.is_cuda and indices.is_cuda
    else:
        if x.shape[-1] != w.shape[-1]:
            raise ValueError(f"contraction mismatch: {tuple(x.shape)} vs "
                             f"{tuple(w.shape)}")
        n, nm = w.shape[0], None
        # one K-padding rule for both backends: order-sensitive policies
        # must see the same (padded) permutation domain to be bit-identical.
        # The plain version pads here; on the card ops.policy_matmul
        # applies the same rule (the global-sort kernels mask the padding
        # instead of copying the weight)
        kp = ops.padded_k(k, policy, k_tile)
        if kp != k and backend == "torch":
            x2 = ops._pad_to(x2, kp, 1)
            w = ops._pad_to(w, kp, 1)
        on_card = x.is_cuda and w.is_cuda
    if backend == "cuda" and not on_card:
        raise ValueError("backend='cuda' needs CUDA tensors; CPU tensors "
                         "take backend='torch'")
    if (batch_chunk is None and backend == "cuda"
            and policy == "sorted_tiled" and sort_impl != "onepass"):
        # the two-pass pass 1 keeps (chunk, N, K/k_tile) int32 tile sums
        # and a permutation of the same shape in device memory: chunk M
        # so they stay bounded (exact: every dot is independent)
        per_row = 2 * 4 * n * max(kp // k_tile, 1)
        batch_chunk = max(_SORT_STATS_BUDGET // per_row, 1)
    out = _local_dot(x2, w, acc_bits=acc_bits, policy=policy,
                     k_tile=k_tile, rounds=rounds, backend=backend,
                     batch_chunk=batch_chunk, certified=certified,
                     m_group=nm, nm_impl=nm_impl, sort_impl=sort_impl)
    out = out.reshape(*lead, n)
    if with_census:
        return out, _census(x2, w, acc_bits, nm)
    return out


# ---------------------------------------------------------------------------
# integer execution of QTensor projections (serving path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IntegerLinConfig:
    """How ``models.layers.lin`` executes QTensor weights.

    The defaults are the serving default of the JAX package: the paper's
    tiled sort (``sorted_tiled_seq``) at a 16-bit register, k_tile 256.
    ``use_static_acts`` picks a QTensor's calibrated ``act_qparams`` over
    the dynamic per-call absmax when it carries them. ``nm_impl`` picks
    the kernel for SparseQTensor weights (None = ``auto``). ``site_policies`` /
    ``site_acc_bits`` are per-site overrides, ((site, value), ...): the
    census degradation swaps one site without touching the rest.

    ``certificate`` (a ``core.certify.Certificate``) turns on the
    certified path: a site whose proof reaches this config's (acc_bits,
    act_bits) runs ``pqs_dot(certified=True)``, census-free, and is
    invisible to any ``census_monitor``. The engine verifies the
    certificate's weight hashes against the served params at
    construction.
    """

    policy: str = "sorted_tiled_seq"
    acc_bits: int = 16
    k_tile: int = 256
    rounds: int = 1
    act_bits: int = 8
    backend: Optional[str] = None  # None = by the operands' device
    use_static_acts: bool = True
    nm_impl: Optional[str] = None  # compressed weights: auto|expand|gather
    site_policies: tuple = ()
    site_acc_bits: tuple = ()
    certificate: Any = None  # core.certify.Certificate -> certified path

    def policy_for(self, site: Optional[str]) -> str:
        return dict(self.site_policies).get(site, self.policy)

    def acc_bits_for(self, site: Optional[str]) -> int:
        return dict(self.site_acc_bits).get(site, self.acc_bits)

    def certified_for(self, site: Optional[str], act_bits: int) -> bool:
        """Does the attached certificate prove this site safe as served?"""
        return (self.certificate is not None and site is not None
                and self.certificate.covers(site, self.acc_bits_for(site),
                                            act_bits))

    def with_site_policy(self, site: str, policy: str) -> "IntegerLinConfig":
        over = dict(self.site_policies)
        over[site] = policy
        return dataclasses.replace(
            self, site_policies=tuple(sorted(over.items())))

    def with_site_acc_bits(self, site: str, bits: int) -> "IntegerLinConfig":
        over = dict(self.site_acc_bits)
        over[site] = int(bits)
        return dataclasses.replace(
            self, site_acc_bits=tuple(sorted(over.items())))

    def without_site(self, site: str) -> "IntegerLinConfig":
        """Drop every per-site override for ``site`` (the undegrade)."""
        return dataclasses.replace(
            self,
            site_policies=tuple((s, p) for s, p in self.site_policies
                                if s != site),
            site_acc_bits=tuple((s, b) for s, b in self.site_acc_bits
                                if s != site))


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


_CALIBRATION: list = []


def calibration_store():
    """Active ``core.quant.ActCalibrator``, or None outside calibration."""
    return _CALIBRATION[-1] if _CALIBRATION else None


@contextlib.contextmanager
def calibration(store):
    """Collect activation ranges at QTensor projection sites: inside the
    context ``models.layers.lin`` reports each QTensor input's float32
    (min, max) to ``store`` (an ``ActCalibrator``) and runs as it would
    outside. Freeze with ``store.freeze()`` +
    ``core.qtensor.attach_act_qparams``."""
    _CALIBRATION.append(store)
    try:
        yield store
    finally:
        _CALIBRATION.pop()


def _host_ints(values: list) -> list[int]:
    """Python ints of a list of ints and 0-d tensors: one host copy for
    the tensors of each (device, dtype), not one a tensor."""
    out = list(values)
    groups: dict = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(i)
    for idx in groups.values():
        host = torch.stack([values[i].reshape(()) for i in idx]).to(
            torch.int64).cpu().tolist()
        for i, h in zip(idx, host):
            out[i] = h
    return [int(v) for v in out]


class CensusMonitor:
    """Per-site overflow-census accumulator, the runtime guardrail's input.

    ``qtensor_dot`` reports, for every named site run under a
    ``census_monitor`` context, its number of dot products and of
    overflow events (persistent or transient, plus combine). Counts are
    Python ints or 0-d tensors on any device; tensors stay where they are
    until ``totals`` / ``drain`` read them, one host copy for the whole
    window, so a decode step never waits on the device for them. ``wide``
    sites report zero events, so a degraded site's rate reads 0.0.
    """

    def __init__(self):
        self._dots: dict[str, list] = {}
        self._events: dict[str, list] = {}

    def observe(self, site, n_dots, n_events) -> None:
        site = str(site)
        self._dots.setdefault(site, []).append(n_dots)
        self._events.setdefault(site, []).append(n_events)

    def totals(self) -> dict[str, tuple[int, int]]:
        sites = list(self._dots)
        flat = [v for s in sites for v in self._dots[s] + self._events[s]]
        ints = iter(_host_ints(flat))
        out = {}
        for s in sites:
            dots = sum(next(ints) for _ in self._dots[s])
            events = sum(next(ints) for _ in self._events[s])
            out[s] = (dots, events)
        return out

    def rates(self) -> dict[str, float]:
        return {s: (e / d if d else 0.0)
                for s, (d, e) in self.totals().items()}

    def drain(self) -> dict[str, tuple[int, int]]:
        out = self.totals()
        self._dots.clear()
        self._events.clear()
        return out


_CENSUS_MON: list[CensusMonitor] = []


def census_monitor_store() -> Optional[CensusMonitor]:
    """Active ``CensusMonitor``, or None when monitoring is off."""
    return _CENSUS_MON[-1] if _CENSUS_MON else None


@contextlib.contextmanager
def census_monitor(mon: Optional[CensusMonitor] = None):
    """Count overflow events per projection site inside the context: one
    census per named projection, so serving enables it only when a
    ``CensusWatch`` is configured."""
    mon = mon or CensusMonitor()
    _CENSUS_MON.append(mon)
    try:
        yield mon
    finally:
        _CENSUS_MON.pop()


@dataclasses.dataclass(frozen=True)
class QATQuantConfig:
    """Accumulator-aware QAT at float linear sites (``a2q_qat`` context).

    Inside the context every named ``models.layers.lin`` whose weight is a
    float 2-D matrix with min(shape) >= ``min_dim`` runs
    ``core.a2q.a2q_fake_quant``: per-channel quantize, accumulator
    projection against the sign-split bound of (``acc_bits``,
    ``act_bits``) and dequantize, under a straight-through estimator.

    ``census_rows`` > 0 adds the overflow census as a training signal:
    that many activation rows, quantized without gradient, go through
    ``core.overflow.census`` against the projected integer weights, and
    each site reports (dots, events) to the active ``census_monitor``,
    as serving's sites do.
    """

    weight_bits: int = 8
    acc_bits: int = 16
    act_bits: int = 8
    min_dim: int = 16
    census_rows: int = 4


_A2Q_QAT: list[QATQuantConfig] = []


def a2q_qat_config() -> Optional[QATQuantConfig]:
    """Active QAT config, or None outside ``a2q_qat``."""
    return _A2Q_QAT[-1] if _A2Q_QAT else None


@contextlib.contextmanager
def a2q_qat(cfg: Optional[QATQuantConfig] = None, **kw):
    """Run accumulator-aware fake quantization at float ``lin`` weights
    inside the context (eager: every step run inside it takes it)."""
    _A2Q_QAT.append(cfg or QATQuantConfig(**kw))
    try:
        yield _A2Q_QAT[-1]
    finally:
        _A2Q_QAT.pop()


def a2q_qat_lin(x: torch.Tensor, w: torch.Tensor, qcfg: QATQuantConfig,
                site: Optional[str] = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) with A2Q-projected fake-quant weights;
    a named site reports its census to the active monitor directly (the
    JAX package's ``jax.debug.callback``)."""
    w_fq = a2q_fake_quant(w.T.to(torch.float32), qcfg.weight_bits,
                          qcfg.acc_bits, act_bits=qcfg.act_bits).T
    mon = census_monitor_store()
    if mon is not None and site is not None and qcfg.census_rows > 0:
        with torch.no_grad():
            wq, _ = a2q_quantize_project(
                w.T.to(torch.float32), qcfg.weight_bits, qcfg.acc_bits,
                act_bits=qcfg.act_bits)
            xs = x.detach().reshape(-1, x.shape[-1])[: qcfg.census_rows
                                                      ].to(torch.float32)
            qmax = 2 ** (qcfg.act_bits - 1) - 1
            # times the reciprocal, as XLA compiles the JAX package's
            # jitted division by the constant qmax
            s_x = torch.clamp(xs.abs().amax(), min=1e-8) * (1.0 / qmax)
            xq = torch.clamp(torch.round(xs / s_x), -qmax - 1, qmax
                             ).to(torch.int32)
            cns = census(partial_products(wq, xq), qcfg.acc_bits)
        mon.observe(site, cns.n_dots, cns.n_any)
    return (x.to(torch.float32) @ w_fq).to(x.dtype)


def qtensor_dot(
    x: torch.Tensor, qt, cfg: IntegerLinConfig, site: Optional[str] = None
) -> torch.Tensor:
    """x (..., in) float @ QTensor or SparseQTensor (in, out) as an integer
    PQS dot; compressed slabs go to ``pqs_dot(storage="nm")`` as they are.

    Activations are quantized per tensor: with the QTensor's static
    ``act_qparams`` when present (and ``cfg.use_static_acts``), else
    dynamically at act_bits from the absmax over the WHOLE tensor, every
    row included. The dynamic scale is computed in the activation dtype
    and only then cast to f32, as the JAX package does, so a bf16 step
    uses the bf16-rounded scale. The output is rescaled by the activation
    scale times the per-channel weight scales, then cast to x.dtype.

    Under a ``census_monitor`` a named site reports (dots, events): its
    census when its policy is not ``wide``, (dots, 0) when it is; a site
    the config's certificate covers runs certified and reports nothing.
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
    sparse = isinstance(qt, SparseQTensor)
    policy = cfg.policy_for(site)
    # act_bits is the code range admissible on this path, the quantity
    # the certificate's bound was taken over
    certified = cfg.certified_for(site, act_bits)
    mon = census_monitor_store()
    want_census = (mon is not None and site is not None
                   and policy != "wide" and not certified)
    res = pqs_dot(xq, qt if sparse else qt.values_t,
                  acc_bits=cfg.acc_bits_for(site), policy=policy,
                  k_tile=cfg.k_tile, rounds=cfg.rounds, backend=cfg.backend,
                  storage="nm" if sparse else "dense",
                  nm_impl=cfg.nm_impl if sparse else None,
                  with_census=want_census, certified=certified)
    if want_census:
        z, cns = res
        mon.observe(site, cns.n_dots, cns.n_any + cns.n_combine)
    else:
        z = res
        if mon is not None and site is not None and not certified:
            # wide accumulates in int32, overflow-free: report the dots
            # so a degraded site's rate reads 0.0
            mon.observe(site, z.numel(), 0)
    if static and not aq.symmetric:
        z = z - qt.act_corr  # Eq. (3) offset correction, frozen per weight
    zf = z.to(torch.float32) * (s_x * qt.scale)
    return zf.to(x.dtype)
