"""Carry the JAX package's state to the port's tests as numpy: quantized
parameter trees in the form ``repro_torch.convert.params_from_numpy``
reads (frozen activation QParams and ``act_corr`` included), and a paper
net's layers and frozen layers in the forms of
``papernet_layers_from_numpy`` and ``frozen_layers_from_numpy``."""

import numpy as np

from repro.core import qtensor as jqt


def to_numpy(tree):
    if isinstance(tree, (jqt.QTensor, jqt.SparseQTensor)):
        out = {"values": np.array(tree.values), "scale": np.array(tree.scale)}
        if isinstance(tree, jqt.SparseQTensor):
            out.update(indices=np.array(tree.indices), m_group=tree.m_group,
                       k_dim=tree.k_dim)
        aq = tree.act_qparams
        if aq is not None:
            out["act_qparams"] = {"scale": np.array(aq.scale),
                                  "offset": np.array(aq.offset),
                                  "bits": int(aq.bits),
                                  "symmetric": bool(aq.symmetric)}
        if tree.act_corr is not None:
            out["act_corr"] = np.array(tree.act_corr)
        return out
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.array(tree)



def _qparams(qp):
    return {"scale": np.array(qp.scale), "offset": np.array(qp.offset),
            "bits": int(qp.bits), "symmetric": bool(qp.symmetric)}


def papernet_layers(layers):
    """A paper net's training layers (``w``, ``b``, ``mask`` and the
    ``EmaRange`` fields)."""
    out = []
    for layer in layers:
        rng = layer["act_range"]
        out.append({"w": np.array(layer["w"]), "b": np.array(layer["b"]),
                    "mask": np.array(layer["mask"]),
                    "act_range": {"lo": np.array(rng.lo),
                                  "hi": np.array(rng.hi),
                                  "n": float(np.asarray(rng.n)),
                                  "decay": float(rng.decay)}})
    return out


def frozen_layers(frozen):
    """A paper net's frozen layers (``wq``, ``b`` and both QParams)."""
    return [{"wq": np.array(f["wq"]), "b": np.array(f["b"]),
             "w_qp": _qparams(f["w_qp"]), "x_qp": _qparams(f["x_qp"])}
            for f in frozen]
