"""Accumulator-safety certification: frozen weights -> proof of no overflow;
torch port of ``repro.core.certify``.

The census (``core.overflow``, the serving engine's ``CensusWatch``)
*observes* accumulator safety at serving time; this module *proves* it
ahead of time, so a certified site drops the census and the stepwise
saturation from its path (``pqs_dot(..., certified=True)``).

The bound. Serving clips activation codes to qrange(b) = [qlo, qhi] on
every path (static asymmetric, static symmetric, dynamic; see
``dispatch.qtensor_dot``). For one output row with integer weights w,
with wp the sum of its positive entries and wn of its |negative| ones,

    pos(w) = qhi * wp + |qlo| * wn      (every product driven positive)
    neg(w) = |qlo| * wp + qhi * wn      (every product driven negative)

Every intermediate value of any accumulation order is a subset sum of
the K products and lies in [-neg(w), pos(w)]. So if pos(w) <= 2^(p-1)-1
and neg(w) <= 2^(p-1), a p-bit register never saturates, under any
policy, and the narrow result equals the exact sum bit for bit.
``acc_bits_safe`` is the smallest such p. Compressed rows sum only their
kept weights: a pruned product never fires.

Certificates hash the integer weight codes only (not scales, not
activation QParams), so a re-calibration or a drifted workload never
invalidates one. The JAX package stacks the layers into (L, ...) leaves
and the port keeps a list of per-layer dicts: a site's leaves here are
hashed as the JAX package's stacked leaf (the shape string of the
stacked array, its bytes in layer order), so a certificate issued by
either package verifies on the other's weights. All arithmetic is host
numpy int64, exact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import pickle
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.qtensor import QTensor, SparseQTensor, is_qtensor
from repro_torch.core.quant import qrange
from repro_torch.core.tree import LayerStack


class CertificateError(ValueError):
    """Certificate does not match the parameters it is asked to cover."""


def acc_caps(acc_bits: int) -> tuple[int, int]:
    """(max positive value, max negative magnitude) of a p-bit register."""
    return 2 ** (acc_bits - 1) - 1, 2 ** (acc_bits - 1)


def row_excursions(wq: np.ndarray, act_bits: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Exact worst-case (pos, neg) excursions per row. wq: (..., K) ints.
    The sums are taken in int64 straight from ``wq``'s own integer type
    (wn = wp - sum(w)), without an int64 copy of the rows."""
    qlo, qhi = qrange(act_bits)
    w = np.asarray(wq)
    wp = np.maximum(w, 0).sum(axis=-1, dtype=np.int64)
    wn = wp - w.sum(axis=-1, dtype=np.int64)
    return qhi * wp + (-qlo) * wn, (-qlo) * wp + qhi * wn


def min_acc_bits(pos: np.ndarray, neg: np.ndarray) -> int:
    """Smallest p with pos <= 2^(p-1)-1 and neg <= 2^(p-1), elementwise."""
    pmax = int(np.max(pos, initial=0))
    nmax = int(np.max(neg, initial=0))
    p = 2
    while True:
        cap_pos, cap_neg = acc_caps(p)
        if pmax <= cap_pos and nmax <= cap_neg:
            return p
        p += 1


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _leaf_rows(leaf) -> np.ndarray:
    """Integer weight rows (R, K), one an output channel: dense (..., in,
    out) transposed to channel-major; compressed (..., out, G, n_keep)
    flattened to its kept weights, the only ones that can fire."""
    v = _host(leaf.values)
    if isinstance(leaf, SparseQTensor):
        return v.reshape(-1, v.shape[-2] * v.shape[-1])
    return np.swapaxes(v, -1, -2).reshape(-1, v.shape[-2])


@dataclasses.dataclass
class _SiteLeaf:
    """One leaf as the JAX package holds it: the per-layer leaves of a
    layer list stacked along a new axis 0 (``stacked``), or one leaf."""

    parts: list
    stacked: bool


def _leaf_hash(leaf: _SiteLeaf) -> str:
    """sha256 over the integer content (values; and indices and geometry
    for compressed storage) of the stacked leaf, streamed a layer at a
    time: a stacked array's bytes are its layers' bytes in order."""
    first = leaf.parts[0]
    shape = tuple(int(d) for d in first.values.shape)
    if leaf.stacked:
        shape = (len(leaf.parts),) + shape
    h = hashlib.sha256()
    h.update(str(shape).encode())
    for part in leaf.parts:
        h.update(_host(part.values).tobytes())
    if isinstance(first, SparseQTensor):
        for part in leaf.parts:
            h.update(_host(part.indices).tobytes())
        h.update(f"{first.m_group},{first.k_dim}".encode())
    return h.hexdigest()


def _stacked_rows(rows: list) -> QTensor:
    """The 1-D QTensor rows of a ``LayerStack`` (one layer's row of a
    quantized layer-stacked vector each) as the (L, out) QTensor the JAX
    package holds."""
    return QTensor(torch.stack([r.values for r in rows]), rows[0].scale,
                   rows[0].act_qparams)


def _site_leaves(params: Any) -> dict[str, list[_SiteLeaf]]:
    """Every QTensor / SparseQTensor leaf grouped by call-site name (the
    last string key on its path), each ``LayerStack``'s leaves stacked."""
    sites: dict[str, list[_SiteLeaf]] = {}

    def walk(node, site):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k if isinstance(k, str) else site)
        elif isinstance(node, (list, tuple)):
            if isinstance(node, LayerStack) and node:
                walk_stack(list(node), site)
            else:
                for v in node:
                    walk(v, site)
        elif is_qtensor(node):
            sites.setdefault(site, []).append(_SiteLeaf([node], False))

    def walk_stack(dicts, site):
        for key in dicts[0]:
            vals = [d.get(key) for d in dicts]
            name = key if isinstance(key, str) else site
            if all(isinstance(v, dict) for v in vals):
                walk_stack(vals, name)
            elif all(isinstance(v, QTensor) and v.ndim == 1 for v in vals):
                sites.setdefault(name, []).append(
                    _SiteLeaf([_stacked_rows(vals)], False))
            elif all(is_qtensor(v) for v in vals):
                sites.setdefault(name, []).append(_SiteLeaf(vals, True))
            else:
                for v in vals:
                    walk(v, name)

    walk(params, "")
    return sites


def _combined_hash(hashes: list[str]) -> str:
    if len(hashes) == 1:
        return hashes[0]
    h = hashlib.sha256()
    for part in sorted(hashes):
        h.update(part.encode())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class SiteCertificate:
    """Proof record for one linear call site (hashable Python scalars)."""

    site: str
    acc_bits_safe: int  # smallest register width that can never saturate
    bound_pos: int      # worst-case positive excursion over all rows
    bound_neg: int      # worst-case negative magnitude over all rows
    slack: float        # headroom at the certified target width (< 0: none)
    act_bits: int       # activation code range the bound was taken over
    weight_hash: str    # sha256 of the integer weights it certifies


class _Unpickler(pickle.Unpickler):
    """Unpickles the port's own certificate classes and nothing else."""

    def find_class(self, module, name):
        if module == __name__ and name in ("Certificate", "SiteCertificate"):
            return globals()[name]
        raise CertificateError(
            f"blob names {module}.{name}, not a certificate of this package")


@dataclasses.dataclass(frozen=True)
class Certificate:
    """Per-site accumulator-safety proofs riding on a checkpoint.

    Policy-independent: the subset-sum bound covers every accumulation
    order, so one certificate serves every policy and both storages.
    """

    sites: tuple[SiteCertificate, ...]
    acc_bits: int  # target register width the slack was measured against

    def site(self, name: str) -> Optional[SiteCertificate]:
        for sc in self.sites:
            if sc.site == name:
                return sc
        return None

    def covers(self, name: str, acc_bits: int, act_bits: int) -> bool:
        """Is (site, register width, activation bits) provably safe?
        Fewer activation bits than certified only shrink the code range,
        so they stay covered."""
        sc = self.site(name)
        return (sc is not None and sc.acc_bits_safe <= acc_bits
                and act_bits <= sc.act_bits)

    def verify(self, params: Any) -> None:
        """Raise CertificateError unless params carry the certified
        weights. A site of params the certificate does not name is simply
        uncertified; a certified site whose integer weights changed is a
        hard error."""
        sites = _site_leaves(params)
        bad = []
        for sc in self.sites:
            leaves = sites.get(sc.site)
            if leaves is None:
                bad.append(f"{sc.site}: missing from params")
                continue
            if _combined_hash([_leaf_hash(l) for l in leaves]) != \
                    sc.weight_hash:
                bad.append(f"{sc.site}: weight hash mismatch")
        if bad:
            raise CertificateError(
                "certificate does not match parameters — " + "; ".join(bad))

    def summary(self) -> str:
        lines = [f"certificate: target acc_bits={self.acc_bits}"]
        for sc in self.sites:
            ok = "ok" if sc.acc_bits_safe <= self.acc_bits else "UNCOVERED"
            lines.append(
                f"  {sc.site}: acc_bits_safe={sc.acc_bits_safe} "
                f"slack={sc.slack:+.3f} act_bits={sc.act_bits} [{ok}]")
        return "\n".join(lines)

    # checkpoint riding: one uint8 blob leaf
    def to_leaf(self) -> np.ndarray:
        return np.frombuffer(pickle.dumps(self), dtype=np.uint8)

    @staticmethod
    def from_leaf(leaf) -> "Certificate":
        """The certificate of a ``to_leaf`` blob; a blob naming any other
        class (a JAX package certificate among them) raises
        CertificateError: carry one across by its fields
        (``convert.certificate_from_fields``)."""
        blob = np.asarray(leaf, dtype=np.uint8).tobytes()
        cert = _Unpickler(io.BytesIO(blob)).load()
        if not isinstance(cert, Certificate):
            raise CertificateError("blob does not decode to a Certificate")
        return cert


def certify_params(params: Any, acc_bits: int, act_bits: int = 8
                   ) -> Certificate:
    """Exact per-site accumulation bounds for a quantized tree.

    ``act_bits`` is the serving activation width of leaves without frozen
    act_qparams; a leaf that carries them is certified at its own frozen
    width. Every QTensor / SparseQTensor leaf is certified;
    ``Certificate.covers`` decides per site whether the proof reaches the
    width a config serves at.
    """
    cap_pos, cap_neg = acc_caps(acc_bits)
    site_certs = []
    for name, leaves in sorted(_site_leaves(params).items()):
        pos_max = neg_max = 0
        safe = 2
        bits = act_bits
        hashes = []
        for leaf in leaves:
            aq = leaf.parts[0].act_qparams
            leaf_bits = int(aq.bits) if aq is not None else act_bits
            bits = max(bits, leaf_bits)
            for part in leaf.parts:  # rows never span layers
                pos, neg = row_excursions(_leaf_rows(part), leaf_bits)
                pos_max = max(pos_max, int(np.max(pos, initial=0)))
                neg_max = max(neg_max, int(np.max(neg, initial=0)))
                safe = max(safe, min_acc_bits(pos, neg))
            hashes.append(_leaf_hash(leaf))
        slack = 1.0 - max(pos_max / cap_pos, neg_max / cap_neg)
        site_certs.append(SiteCertificate(
            site=name, acc_bits_safe=safe, bound_pos=pos_max,
            bound_neg=neg_max, slack=slack, act_bits=bits,
            weight_hash=_combined_hash(hashes)))
    return Certificate(sites=tuple(site_certs), acc_bits=acc_bits)


def truncate_rows(wq: np.ndarray, acc_bits: int, act_bits: int = 8
                  ) -> np.ndarray:
    """Truncate integer rows toward zero until the bound holds. (R, K) ->.

    |trunc(w * f)| <= f * |w| elementwise with signs kept, so both
    sign-split sums contract by at least f and the row lands inside the
    caps. Exact int64 / float64 host arithmetic.
    """
    cap_pos, cap_neg = acc_caps(acc_bits)
    w = np.asarray(wq)
    pos, neg = row_excursions(w, act_bits)
    factor = np.minimum(
        1.0,
        np.minimum(cap_pos / np.maximum(pos, 1), cap_neg / np.maximum(neg, 1)),
    )
    # |trunc(w * f)| <= |w| with f <= 1: the result fits w's own type
    return np.trunc(w * factor[..., None]).astype(w.dtype)


def _enforce_leaf(leaf, acc_bits: int, act_bits: int):
    """One leaf's rows truncated inside the caps; act_corr recomputed
    where the leaf carries frozen asymmetric QParams."""
    aq = leaf.act_qparams
    bits = int(aq.bits) if aq is not None else act_bits
    v = _host(leaf.values)
    dev = leaf.values.device
    sparse = isinstance(leaf, SparseQTensor)
    if sparse:
        rows = v.reshape(-1, v.shape[-2] * v.shape[-1])
        new_v = truncate_rows(rows, acc_bits, bits).reshape(v.shape)
        wsum_axes = (-2, -1)
    else:
        rows = np.swapaxes(v, -1, -2).reshape(-1, v.shape[-2])
        new_v = truncate_rows(rows, acc_bits, bits)
        new_v = np.swapaxes(
            new_v.reshape(v.shape[:-2] + (v.shape[-1], v.shape[-2])), -1, -2)
    corr = leaf.act_corr
    if corr is not None:
        wsum = new_v.astype(np.int64).sum(axis=wsum_axes if sparse else -2)
        corr = torch.from_numpy(
            _host(aq.offset)[..., None] * wsum.astype(np.int32)).to(dev)
    values = torch.from_numpy(np.ascontiguousarray(new_v)).to(dev)
    if sparse:
        return dataclasses.replace(leaf, values=values, act_corr=corr)
    return QTensor(values, leaf.scale, aq, corr)


def enforce_acc_bounds(params: Any, acc_bits: int, act_bits: int = 8) -> Any:
    """Project every quantized leaf inside the certifiable region: rows
    over the bound are truncated in the integer domain (rows inside it
    pass through bit for bit), act_corr recomputed for leaves that carry
    frozen asymmetric QParams. The 1-D QTensor rows of a ``LayerStack`` are
    truncated as the JAX package's (L, out) leaf, whose rows run across
    the layers."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if isinstance(node, LayerStack) and node:
                return type(node)(walk_stack(list(node)))
            return type(node)(walk(v) for v in node)
        if is_qtensor(node):
            return _enforce_leaf(node, acc_bits, act_bits)
        return node

    def walk_stack(dicts):
        done = {}
        for key in dicts[0]:
            vals = [d.get(key) for d in dicts]
            if all(isinstance(v, dict) for v in vals):
                done[key] = walk_stack(vals)
            elif all(isinstance(v, QTensor) and v.ndim == 1 for v in vals):
                stacked = _enforce_leaf(_stacked_rows(vals), acc_bits,
                                        act_bits)
                done[key] = [dataclasses.replace(v, values=row,
                                                 values_t=None)
                             for v, row in zip(vals, stacked.values)]
        return [{k: done[k][i] if k in done else walk(v)
                 for k, v in d.items()} for i, d in enumerate(dicts)]

    return walk(params)
