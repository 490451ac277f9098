"""Carry the JAX package's quantized parameter trees to the port's tests:
every leaf as numpy, in the form ``repro_torch.convert.params_from_numpy``
reads (frozen activation QParams and ``act_corr`` included)."""

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
    return np.array(tree)

