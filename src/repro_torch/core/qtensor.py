"""QTensor and SparseQTensor: int8 N:M-pruned weight carriers, torch port
of ``repro.core.qtensor``.

The public layout is the JAX package's. A dense ``QTensor`` keeps
``values`` (in, out) int8, the layout of the float weight it replaces;
the integer dot consumes the weight as (out, in) rows, so a 2-D QTensor
(a projection) also keeps a contiguous ``values_t`` copy, made once when
the QTensor is built instead of a transpose and copy on every call. A
stack of matrices (an MoE layer's experts, (E, in, out)) is only ever
dequantized, so it keeps none. A ``SparseQTensor`` keeps the compressed
slabs (out, G, n_keep) that the N:M kernels stream (``core.pruning``
describes the format).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.pruning import nm_compress, nm_decompress, nm_prune_mask
from repro_torch.core.quant import QParams, qrange
from repro_torch.core.tree import LayerStack, tree_map


@dataclasses.dataclass
class QTensor:
    """Per-output-channel symmetric int8 weight + f32 scale.

    values: (..., in, out) int8; scale: (..., out) f32.
    act_qparams: optional calibrated static input-activation QParams.
    act_corr: with asymmetric act_qparams, the Eq. (3) correction
        o_x * sum_k w_k^q per output channel (int32).
    values_t: (out, in) contiguous int8 copy of 2-D ``values``; None for
        a stack, which no integer dot reads.
    """

    values: torch.Tensor
    scale: torch.Tensor
    act_qparams: Optional[QParams] = None
    act_corr: Optional[torch.Tensor] = None
    values_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        # a 1-D QTensor is one layer's row of a quantized layer-stacked
        # vector (quantize_tree); it has no (out, in) form
        if self.values_t is None and self.values.ndim == 2:
            self.values_t = self.values.transpose(-1, -2).contiguous()

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """(..., in, out) in ``dtype``: each column times its scale, a
        stack's matrix by matrix (scale (..., out)), elementwise what
        ``SparseQTensor.dequant`` gives for the same codes."""
        scale = self.scale[..., None, :] if self.values.ndim >= 2 \
            else self.scale  # a 1-D row: (out,) codes, (out,) scale
        return (self.values.to(torch.float32) * scale).to(dtype)


@dataclasses.dataclass
class SparseQTensor:
    """N:M-compressed int8 weight: the P of PQS as a storage format.

    values:  (..., out, G, n_keep) int8, G = ceil(in / m_group)
    indices: (..., out, G, n_keep) int32 position in each m-group
    scale:   (..., out) f32 per-output-channel scales
    m_group, k_dim: group size and the logical contraction length
        (k_dim <= G * m_group; a tail group is zero-padded)
    act_qparams / act_corr: as on ``QTensor``; the kept-only sum is the
        dense sum, so the Eq. (3) correction is unchanged.
    """

    values: torch.Tensor
    indices: torch.Tensor
    scale: torch.Tensor
    m_group: int
    k_dim: int
    act_qparams: Optional[QParams] = None
    act_corr: Optional[torch.Tensor] = None

    @property
    def shape(self):
        """Logical dense (..., in, out) shape: what the float weight had."""
        return (*self.values.shape[:-3], self.k_dim, self.values.shape[-3])

    @property
    def ndim(self):
        return self.values.ndim - 1

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        """Dense (..., in, out), contiguous: elementwise and in layout what
        ``QTensor.dequant`` gives for the same codes."""
        dense = nm_decompress(self.values.to(torch.float32), self.indices,
                              self.m_group, self.k_dim)  # (..., out, in)
        dense = dense.transpose(-1, -2).contiguous()
        return (dense * self.scale[..., None, :]).to(dtype)

    def input_rows(self, pos: torch.Tensor) -> torch.Tensor:
        """Integer codes of the logical rows ``pos`` (any shape of input
        positions) -> pos.shape + (out,) int32, without decompressing the
        rest: row t is sum_j values[:, t // m, j] * [indices[:, t // m, j]
        == t % m] (2-D slabs only)."""
        m = self.m_group
        vals = self.values[:, pos // m].to(torch.int32)  # (out, *pos, n)
        hit = self.indices[:, pos // m] == (pos % m)[..., None]
        codes = torch.where(hit, vals, 0).sum(dim=-1, dtype=torch.int32)
        # contiguous, as a dense table's rows are: later layers then see
        # the same layouts (and float reduction orders) as the dense path
        return torch.movedim(codes, 0, -1).contiguous()


def qtensor_nm_compress(qt: QTensor, n_keep: int, m_group: int
                        ) -> SparseQTensor:
    """Pack an N:M-pruned ``QTensor`` into a ``SparseQTensor``; a dense
    leaf with more than n_keep nonzeros in a group raises. Calibrated
    ``act_qparams`` / ``act_corr`` ride along unchanged."""
    vals, idx = nm_compress(qt.values.transpose(-1, -2), n_keep, m_group)
    return SparseQTensor(vals.contiguous(), idx.contiguous(), qt.scale,
                         m_group, qt.values.shape[-2], qt.act_qparams,
                         qt.act_corr)


def nm_compress_tree(params: Any, n_keep: int, m: int = 16) -> Any:
    """Convert every n_keep:m-sparse QTensor leaf to a ``SparseQTensor``.

    Leaves that are not that sparse stay dense QTensors (ragged in dims
    quantize unpruned), so the tree may be mixed. Invalid (n_keep, m)
    raise up front, and so does a tree in which no QTensor leaf matched
    the pattern: it would otherwise serve fully dense, silently.

    Leaves are taken one by one, a ``LayerStack``'s layer by layer: the
    JAX package compresses a stacked (L, in, out) leaf matrix by matrix,
    so the slabs are the same. A 1-D QTensor row (one layer's row of a
    quantized layer-stacked vector, ``quantize_tree``) stays dense on
    purpose and is not counted:
    its N:M groups would run across the layers, and a layer reads only
    its own row (``asarray``). The JAX package compresses the stacked
    (L, out) leaf when L % m == 0 and counts it; compression is lossless,
    so both trees serve the same values.
    """
    if m < 1:
        raise ValueError(f"m_group must be >= 1, got {m}")
    if not 1 <= n_keep <= m:
        raise ValueError(f"n_keep={n_keep} out of range [1, {m}] for M={m}")
    counts = {"dense": 0, "converted": 0}

    def conv(leaf):
        if not isinstance(leaf, QTensor) or leaf.ndim < 2:
            return leaf  # a quantized bias row has no groups to compress
        counts["dense"] += 1
        try:
            out = qtensor_nm_compress(leaf, n_keep, m)
        except ValueError:
            return leaf  # not n_keep:m sparse: keep the dense form
        counts["converted"] += 1
        return out

    out = tree_map(conv, params)
    if counts["dense"] and not counts["converted"]:
        raise ValueError(
            f"no QTensor leaf ({counts['dense']} seen) is {n_keep}:{m} "
            "sparse — the tree was pruned with a different (n_keep, m) "
            "pattern (or not pruned at all); compressing would silently "
            "serve fully dense")
    return out


def attach_act_qparams(params: Any, frozen: dict[str, QParams]) -> Any:
    """Freeze calibrated activation ranges into a quantized param tree.

    ``frozen`` maps call-site names (the last string key on a leaf's path:
    "wq", "w_gate", ...) to static QParams from ``ActCalibrator.freeze``.
    Every matching QTensor / SparseQTensor, each layer's alike, gets
    QParams whose 0-d scale and offset sit on the weight's device. With
    asymmetric QParams it also gets ``act_corr``, the Eq. (3) term o_x *
    sum_k w_k per output channel, frozen here so decode never reduces
    the weight (a SparseQTensor's kept-only sum is the dense sum).
    """

    def conv(leaf, site):
        if not is_qtensor(leaf) or site not in frozen:
            return leaf
        qp = frozen[site]
        dev = leaf.values.device
        aq = QParams(qp.scale.to(device=dev, dtype=torch.float32),
                     qp.offset.to(device=dev, dtype=torch.int32), qp.bits,
                     qp.symmetric)
        corr = None
        if not qp.symmetric:
            v = leaf.values.to(torch.int32)
            wsum = v.sum(dim=(-2, -1) if isinstance(leaf, SparseQTensor)
                         else -2, dtype=torch.int32)
            corr = aq.offset[..., None] * wsum
        return dataclasses.replace(leaf, act_qparams=aq, act_corr=corr)

    def walk(node, site):
        if isinstance(node, dict):
            return {k: walk(v, k if isinstance(k, str) else site)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, site) for v in node)
        return conv(node, site)

    return walk(params, "")


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
    return isinstance(x, (QTensor, SparseQTensor))


def asarray(w: Any, dtype) -> torch.Tensor:
    """Uniform accessor used by every matmul of the model."""
    if is_qtensor(w):
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

    The skip rules are the JAX package's: leaves under ``min_size``
    elements or with a trailing dim under ``min_dim`` stay float, and a
    leaf whose in dim is not a multiple of ``m`` is quantized without
    pruning. Where the JAX package stacks layers into (L, in, out)
    leaves, the port keeps a ``LayerStack`` of per-layer dicts; a leaf
    inside one counts ``min_size`` over its L layers, as the stacked leaf
    does, and both packages quantize the same leaves. A 1-D leaf (out,)
    of a stack is, stacked, an (L, out) matrix: once it passes the rules
    it is quantized as JAX quantizes that matrix (in = L, one scale per
    column, pruned along the layers when L % m == 0), and each layer
    holds its row: a QTensor of values (out,) and the shared scale
    (out,). A plain list (the hybrid's layers, a list in the JAX package
    too) is walked leaf by leaf.
    """
    device = resolve_device(device)

    def conv(leaf, layers):
        if not isinstance(leaf, torch.Tensor):
            return leaf  # QTensors and plain values pass through
        leaf = leaf.to(device)
        if leaf.ndim < 2 or leaf.numel() * layers < min_size:
            return leaf
        if min(leaf.shape[-2:]) < min_dim or not leaf.is_floating_point():
            return leaf
        keep = n_keep if leaf.shape[-2] % m == 0 else None
        return _quantize_stacked(leaf, bits, keep, m)

    def stacked_rows(rows, layers):
        """The per-layer QTensor rows of one 1-D leaf across a layer list,
        when JAX would quantize its stacked (L, out) matrix; else None."""
        first = rows[0]
        if not all(isinstance(r, torch.Tensor) and r.ndim == 1
                   and r.is_floating_point() and r.shape == first.shape
                   for r in rows):
            return None
        stack = torch.stack(rows).to(device)  # (L, out)
        if (stack.numel() * (layers // len(rows)) < min_size
                or min(stack.shape) < min_dim):
            return None
        keep = n_keep if stack.shape[0] % m == 0 else None
        q = quantize_weight(stack, bits, keep, m)
        return [QTensor(v, q.scale) for v in q.values]

    def walk_stack(dicts, layers):
        """The dicts of one ``LayerStack`` side by side: a key whose values
        are all dicts recurses, a 1-D leaf may quantize across the
        layers."""
        done = {}
        for key in dicts[0]:
            vals = [d.get(key) for d in dicts]
            if all(isinstance(v, dict) for v in vals):
                done[key] = walk_stack(vals, layers)
            else:
                rows = stacked_rows(vals, layers)
                if rows is not None:
                    done[key] = rows
        return [{k: done[k][i] if k in done else walk(v, layers)
                 for k, v in d.items()} for i, d in enumerate(dicts)]

    def walk(node, layers):
        if isinstance(node, dict):
            return {k: walk(v, layers) for k, v in node.items()}
        if isinstance(node, LayerStack) and node:
            # JAX's leading L axis
            return LayerStack(walk_stack(node, layers * len(node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, layers) for v in node)
        return conv(node, layers)

    return walk(params, 1)
