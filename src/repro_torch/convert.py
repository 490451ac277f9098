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
- ``"layers"`` stacked along axis 0, (L, ...), which becomes the port's
  list of per-layer dicts (the ints of a compressed weight are shared,
  and so is the (out,) scale of a quantized stacked vector, whose (L,
  out) codes give each layer its row).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.qtensor import QTensor, SparseQTensor

_SPARSE_KEYS = {"values", "indices", "scale", "m_group", "k_dim"}


def _unstack(node: Any, i: int) -> Any:
    if isinstance(node, dict) and set(node) == {"values", "scale"} and \
            node["values"].ndim == 2:
        # a quantized layer-stacked vector: (L, out) codes, one (out,)
        # scale shared by the layers
        return {"values": node["values"][i], "scale": node["scale"]}
    if isinstance(node, dict):
        return {k: _unstack(v, i) for k, v in node.items()}
    return node[i] if isinstance(node, np.ndarray) else node


def _layer_count(node: Any) -> int:
    while isinstance(node, dict):
        node = next(v for v in node.values() if isinstance(v, (dict,
                                                                np.ndarray)))
    return int(node.shape[0])


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's parameter tree on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict) and set(node) == {"values", "scale"}:
            return QTensor(conv(node["values"]), conv(node["scale"]))
        if isinstance(node, dict) and set(node) == _SPARSE_KEYS:
            return SparseQTensor(conv(node["values"]), conv(node["indices"]),
                                 conv(node["scale"]), int(node["m_group"]),
                                 int(node["k_dim"]))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(node)).to(device)
        raise TypeError(f"unexpected leaf {type(node).__name__}")

    tree = dict(tree)
    if isinstance(tree.get("layers"), dict):
        stacked = tree["layers"]
        tree["layers"] = [_unstack(stacked, i)
                          for i in range(_layer_count(stacked))]
    out = {k: v for k, v in tree.items() if k != "layers"}
    out = conv(out)
    if "layers" in tree:
        out["layers"] = [conv(layer) for layer in tree["layers"]]
    return out
