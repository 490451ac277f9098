"""Load the JAX package's parameters into the port, from numpy arrays.

``params_from_numpy(tree)`` takes the JAX package's parameter tree with
every leaf already a numpy array (the caller does the JAX-to-numpy step,
so nothing here imports JAX):

- nested dicts of arrays, as ``repro`` keeps them;
- a quantized weight as a dict holding ``values`` (in, out) int8 and
  ``scale`` (out,) f32 arrays, which becomes a port ``QTensor``;
- a compressed weight as a dict holding ``values`` (out, G, n_keep) int8,
  ``indices`` (out, G, n_keep) int32, ``scale`` (out,) f32 and the ints
  ``m_group`` and ``k_dim``, which becomes a port ``SparseQTensor``;
- either kind of weight may also hold ``act_qparams``, a dict of
  ``scale`` and ``offset`` arrays and the ints / bools ``bits`` and
  ``symmetric`` (a frozen calibration), and ``act_corr``, the frozen
  Eq. (3) correction;
- the stacked layers, ``"layers"`` (the dense, MoE, vlm and SSM
  families) and ``"enc_layers"`` / ``"dec_layers"`` (the
  encoder-decoder), each a dict of arrays stacked along axis 0, (L,
  ...), which becomes the port's ``LayerStack`` of per-layer dicts (the
  ints of a compressed weight are shared, and so is the (out,) scale of
  a quantized stacked vector, whose (L, out) codes give each layer its
  row; an (L,) act_qparams scale and offset and an (L, out) act_corr
  give each layer its own);
- lists, such as the hybrid's ``"layers"`` (a list of per-layer dicts
  in the JAX package too), which stay lists.

``papernet_layers_from_numpy(layers)`` takes a paper net's layers (a
list of dicts of ``w``, ``b`` and ``mask`` arrays and ``act_range``, a
dict of the ``EmaRange`` fields ``lo``, ``hi``, ``n`` and ``decay``) and
``frozen_layers_from_numpy(frozen)`` its frozen form (``wq`` and ``b``
arrays, and ``w_qp`` / ``x_qp`` dicts of the ``QParams`` fields ``scale``,
``offset``, ``bits`` and ``symmetric``): the ``core.pqs`` layers of the
port. The observer's update count becomes a Python float, as the port
keeps it.

``certificate_from_fields(fields)`` builds the port's ``Certificate`` from
a JAX package certificate's fields as plain Python values
(``dataclasses.asdict``): the hashes cover integer codes only, so it
verifies on the converted weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.certify import Certificate, SiteCertificate
from repro_torch.core.qtensor import QTensor, SparseQTensor
from repro_torch.core.quant import EmaRange, QParams
from repro_torch.core.tree import LayerStack

_DENSE_KEYS = {"values", "scale"}
_SPARSE_KEYS = {"values", "indices", "scale", "m_group", "k_dim"}
_CALIBRATION_KEYS = {"act_qparams", "act_corr"}
_STACKED_KEYS = ("layers", "enc_layers", "dec_layers")


def _weight_keys(node: Any) -> Any:
    """The key set naming a weight dict's kind (dense or compressed), or
    None for any other node."""
    if not isinstance(node, dict):
        return None
    keys = set(node) - _CALIBRATION_KEYS
    return keys if keys in (_DENSE_KEYS, _SPARSE_KEYS) else None


def _unstack(node: Any, i: int) -> Any:
    if _weight_keys(node) == _DENSE_KEYS and node["values"].ndim == 2:
        # a quantized layer-stacked vector: (L, out) codes, one (out,)
        # scale shared by the layers
        return {"values": node["values"][i], "scale": node["scale"]}
    if isinstance(node, dict) and set(node) == {"scale", "offset", "bits",
                                                 "symmetric"}:
        # act_qparams: scale and offset (L,), one bit width
        return {**node, "scale": node["scale"][i],
                "offset": node["offset"][i]}
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i] if isinstance(node, np.ndarray) else node


def _layer_count(node: Any) -> int:
    while isinstance(node, dict):
        node = next(v for v in node.values() if isinstance(v, (dict,
                                                                np.ndarray)))
    return int(node.shape[0])


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    # ascontiguousarray makes a 0-d array 1-d: keep the shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape).to(
        device)


def _qparams(node: dict, device) -> QParams:
    return QParams(_tensor(np.asarray(node["scale"], np.float32), device),
                   _tensor(np.asarray(node["offset"], np.int32), device),
                   int(node["bits"]), bool(node["symmetric"]))


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's parameter tree on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    device = resolve_device(device)

    def calibration(node):
        aq = node.get("act_qparams")
        if aq is not None:
            aq = _qparams(aq, device)
        corr = node.get("act_corr")
        return aq, None if corr is None else conv(corr)

    def conv(node):
        kind = _weight_keys(node)
        if kind == _DENSE_KEYS:
            return QTensor(conv(node["values"]), conv(node["scale"]),
                           *calibration(node))
        if kind == _SPARSE_KEYS:
            return SparseQTensor(conv(node["values"]), conv(node["indices"]),
                                 conv(node["scale"]), int(node["m_group"]),
                                 int(node["k_dim"]), *calibration(node))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, np.ndarray):
            return _tensor(node, device)
        raise TypeError(f"unexpected leaf {type(node).__name__}")

    stacked = {k: v for k, v in tree.items()
               if k in _STACKED_KEYS and isinstance(v, dict)}
    out = conv({k: v for k, v in tree.items() if k not in stacked})
    for k, v in stacked.items():
        out[k] = LayerStack(conv(_unstack(v, i))
                            for i in range(_layer_count(v)))
    return out


def papernet_layers_from_numpy(layers: list, device=None) -> list[dict]:
    """A paper net's training layers on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    out = []
    for layer in layers:
        rng = layer["act_range"]
        out.append({
            **{k: _tensor(layer[k], device) for k in ("w", "b", "mask")},
            "act_range": EmaRange(
                _tensor(np.asarray(rng["lo"], np.float32), device),
                _tensor(np.asarray(rng["hi"], np.float32), device),
                float(rng["decay"]), float(rng["n"])),
        })
    return out


def frozen_layers_from_numpy(frozen: list, device=None) -> list[dict]:
    """A paper net's frozen integer layers on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    return [{"wq": _tensor(f["wq"], device), "b": _tensor(f["b"], device),
             "w_qp": _qparams(f["w_qp"], device),
             "x_qp": _qparams(f["x_qp"], device)} for f in frozen]


def certificate_from_fields(fields: dict) -> Certificate:
    """The port's ``Certificate`` of a JAX package certificate's fields as
    plain Python values (``dataclasses.asdict`` of it): ``sites``, each
    with the fields of ``SiteCertificate``, and ``acc_bits``."""
    sites = tuple(SiteCertificate(
        site=str(sc["site"]), acc_bits_safe=int(sc["acc_bits_safe"]),
        bound_pos=int(sc["bound_pos"]), bound_neg=int(sc["bound_neg"]),
        slack=float(sc["slack"]), act_bits=int(sc["act_bits"]),
        weight_hash=str(sc["weight_hash"])) for sc in fields["sites"])
    return Certificate(sites=sites, acc_bits=int(fields["acc_bits"]))
