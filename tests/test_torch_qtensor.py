"""Quantized weights and the integer linear of the port against the JAX
package: identical int8 codes and f32 scales, and bit-identical
``qtensor_dot`` outputs in float32 and bfloat16, dynamic and static."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jd
from repro.core import qtensor as jqt
from repro.core.quant import activation_qparams, symmetric_activation_qparams
from repro_torch.core import dispatch as td
from repro_torch.core import qtensor as tqt
from repro_torch.core.quant import QParams
from repro_torch.core.tree import LayerStack


def _w(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.1


def _port_qt(jq, aq=None, corr=None):
    return tqt.QTensor(torch.from_numpy(np.array(jq.values)),
                       torch.from_numpy(np.array(jq.scale)), aq, corr)


@pytest.mark.parametrize("n_keep", [None, 8])
def test_quantize_weight(n_keep):
    w = _w(1, (96, 40))
    j = jqt.quantize_weight(jnp.asarray(w), 8, n_keep, 16)
    t = tqt.quantize_weight(torch.from_numpy(w), 8, n_keep, 16)
    assert t.values.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.values_t.numpy(),
                                  np.asarray(j.values).T)


@pytest.mark.parametrize("n_keep", [None, 8])
def test_quantize_tree(n_keep):
    """Same skip rules and codes; stacked (L, in, out) leaves included."""
    tree = {
        "big": _w(2, (64, 48)),
        "stacked": _w(3, (2, 64, 32)),
        "ragged_in": _w(4, (40, 64)),  # in dim not a multiple of 16
        "small": _w(5, (8, 8)),
        "bias": _w(6, (64,)),
    }
    kw = dict(bits=8, n_keep=n_keep, m=16, min_size=1 << 10, min_dim=16)
    j = jqt.quantize_tree({k: jnp.asarray(v) for k, v in tree.items()}, **kw)
    t = tqt.quantize_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                          device="cpu", **kw)
    for k in tree:
        if isinstance(j[k], jqt.QTensor):
            assert isinstance(t[k], tqt.QTensor), k
            np.testing.assert_array_equal(t[k].values.numpy(),
                                          np.asarray(j[k].values))
            np.testing.assert_array_equal(t[k].scale.numpy(),
                                          np.asarray(j[k].scale))
        else:
            assert isinstance(t[k], torch.Tensor), k
    assert isinstance(t["big"], tqt.QTensor)
    assert not isinstance(t["small"], tqt.QTensor)


def test_quantize_tree_counts_one_layer():
    """A ``LayerStack`` quantizes exactly when JAX's stacked (L, in, out)
    leaf does: ``min_size`` counts all L layers in both packages. The
    stacked (2, 48, 48) leaf has 4608 elements, one layer 2304, so at
    min_size 4096 both quantize and at 8192 neither does."""
    w = _w(13, (2, 48, 48))
    for min_size, quantized in ((1 << 12, True), (1 << 13, False)):
        kw = dict(bits=8, n_keep=8, m=16, min_size=min_size, min_dim=16)
        j = jqt.quantize_tree({"wq": jnp.asarray(w)}, **kw)["wq"]
        layers = tqt.quantize_tree(
            LayerStack({"wq": torch.from_numpy(a)} for a in w),
            device="cpu", **kw)
        assert isinstance(j, jqt.QTensor) == quantized
        for i, layer in enumerate(layers):
            assert isinstance(layer["wq"], tqt.QTensor) == quantized
            if quantized:
                np.testing.assert_array_equal(layer["wq"].values.numpy(),
                                              np.asarray(j.values[i]))
                np.testing.assert_array_equal(layer["wq"].scale.numpy(),
                                              np.asarray(j.scale[i]))


@pytest.mark.parametrize("n_keep", [None, 8])
def test_quantize_tree_stacked_bias_matches_jax(n_keep):
    """16 layers of a (48,) bias stack in JAX into a (16, 48) leaf, which
    passes min_dim 16 and is quantized as a matrix (pruned 8:16 along the
    layers when asked); the port quantizes the per-layer rows to the same
    codes and the same scale, and the converted JAX tree is the port's."""
    from repro_torch.convert import params_from_numpy

    b = _w(14, (16, 48))
    kw = dict(bits=8, n_keep=n_keep, m=16, min_size=1 << 8, min_dim=16)
    j = jqt.quantize_tree({"layers": {"b": jnp.asarray(b)}}, **kw)
    j = j["layers"]["b"]
    assert isinstance(j, jqt.QTensor)
    layers = tqt.quantize_tree(
        {"layers": LayerStack({"b": torch.from_numpy(a)} for a in b)},
        device="cpu", **kw)["layers"]
    conv = params_from_numpy(
        {"layers": {"b": {"values": np.array(j.values),
                          "scale": np.array(j.scale)}}}, device="cpu")
    for i, layer in enumerate(layers):
        for got in (layer["b"], conv["layers"][i]["b"]):
            assert isinstance(got, tqt.QTensor)
            np.testing.assert_array_equal(got.values.numpy(),
                                          np.asarray(j.values[i]))
            np.testing.assert_array_equal(got.scale.numpy(),
                                          np.asarray(j.scale))
        np.testing.assert_array_equal(
            tqt.asarray(layer["b"], torch.float32).numpy(),
            np.asarray(j.dequant(jnp.float32))[i])
    if n_keep:
        # JAX compresses the pruned stacked leaf and counts it, the port
        # keeps the rows dense (uncounted); both serve the same values,
        # and beside a sparse matrix leaf both trees convert it
        w = _w(15, (16, 32, 48))
        jt = jqt.nm_compress_tree(jqt.quantize_tree(
            {"layers": {"b": jnp.asarray(b), "w": jnp.asarray(w)}}, **kw),
            n_keep, 16)["layers"]
        tt = tqt.nm_compress_tree(tqt.quantize_tree(
            {"layers": LayerStack({"b": torch.from_numpy(b[i]),
                                   "w": torch.from_numpy(w[i])}
                                  for i in range(16))},
            device="cpu", **kw), n_keep, 16)["layers"]
        assert isinstance(jt["b"], jqt.SparseQTensor)
        assert isinstance(jt["w"], jqt.SparseQTensor)
        for i, layer in enumerate(tt):
            assert isinstance(layer["b"], tqt.QTensor)
            assert isinstance(layer["w"], tqt.SparseQTensor)
            for key in ("b", "w"):
                np.testing.assert_array_equal(
                    tqt.asarray(layer[key], torch.float32).numpy(),
                    np.asarray(jqt.asarray(jt[key], jnp.float32))[i])
        # a tree of rows alone: the port has nothing to convert, no raise
        rows = tqt.nm_compress_tree(layers, n_keep, 16)
        assert all(r["b"] is l["b"] for r, l in zip(rows, layers))
    # below min_dim layers the stacked leaf stays float in both packages
    few = tqt.quantize_tree(
        LayerStack({"b": torch.from_numpy(a)} for a in b[:8]),
        device="cpu", **kw)
    assert all(isinstance(layer["b"], torch.Tensor) for layer in few)


def test_quantized_bias_serves_as_its_dequantized_value():
    """A qkv bias (and a norm scale) quantized with its layer stack is
    read through ``asarray``: the model gives the logits of the same model
    whose quantized rows are the dequantized values as float tensors."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              num_layers=16, compute_dtype="float32")
    assert cfg.qkv_bias
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    gen = torch.Generator().manual_seed(0)
    for layer in params["layers"]:  # init zeroes them; make them count
        for key in ("bq", "bk", "bv"):
            layer["attn"][key] = torch.randn(layer["attn"][key].shape,
                                             generator=gen)
    q = tqt.quantize_tree(params, bits=8, min_size=1 << 8, min_dim=16,
                          device="cpu")
    assert isinstance(q["layers"][0]["attn"]["bq"], tqt.QTensor)
    def rows_to_float(node):
        if isinstance(node, dict):
            return {k: rows_to_float(v) for k, v in node.items()}
        if isinstance(node, tqt.QTensor) and node.ndim == 1:
            return node.dequant(torch.float32)
        return node

    f = {**q, "layers": [rows_to_float(layer) for layer in q["layers"]]}
    toks = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    lengths = torch.tensor([6, 4], dtype=torch.int32)
    outs = []
    for p in (q, f):
        caches = model.init_caches(p, 2, 16, torch.float32)
        outs.append(model.prefill(p, toks, caches, lengths)[0])
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_quantize_tree_smoke_model_matches_jax():
    """The smoke model's float params, converted, quantize in the port to
    the converted JAX ``quantize_tree`` result, leaf for leaf and bit for
    bit: the same leaves quantized, the same codes and scales."""
    from repro.configs import get_config
    from repro.models.model import build_model
    from repro_torch.convert import params_from_numpy

    def to_numpy(tree):
        if isinstance(tree, jqt.QTensor):
            return {"values": np.array(tree.values),
                    "scale": np.array(tree.scale)}
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return np.array(tree)

    params = build_model(get_config("qwen2-1.5b", smoke=True)).init(
        jax.random.PRNGKey(0))
    kw = dict(bits=8, n_keep=8, m=16, min_size=1 << 12, min_dim=16)
    want = params_from_numpy(to_numpy(jqt.quantize_tree(params, **kw)),
                             device="cpu")
    got = tqt.quantize_tree(params_from_numpy(to_numpy(params),
                                              device="cpu"), device="cpu",
                            **kw)
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert want.keys() == got.keys()
    assert any(isinstance(v, tqt.QTensor) for v in want.values())
    for path, w in want.items():
        g = got[path]
        assert type(g) is type(w), path
        if isinstance(w, tqt.QTensor):
            assert torch.equal(g.values, w.values), path
            assert torch.equal(g.scale, w.scale), path
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), path


def _x(seed, dtype):
    x = np.random.default_rng(seed).standard_normal((2, 5, 96)).astype(
        np.float32) * 3.0
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _check(jx, tx, jq, tq_, policy, site=None):
    jcfg = jd.IntegerLinConfig(policy=policy, acc_bits=16, k_tile=32,
                               backend="jnp")
    tcfg = td.IntegerLinConfig(policy=policy, acc_bits=16, k_tile=32)
    want = jd.qtensor_dot(jx, jq, jcfg, site=site)
    got = td.qtensor_dot(tx, tq_, tcfg, site=site)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["sorted_tiled_seq", "clip", "wide"])
def test_qtensor_dot_dynamic(dtype, policy):
    """bfloat16 pins the dtype trap: the absmax scale is computed in
    bf16 and only then cast to f32."""
    jq = jqt.quantize_weight(jnp.asarray(_w(7, (96, 40))), 8, 8, 16)
    jx, tx = _x(8, dtype)
    _check(jx, tx, jq, _port_qt(jq), policy)


@pytest.mark.parametrize("symmetric", [True, False])
def test_qtensor_dot_static(symmetric):
    jq = jqt.quantize_weight(jnp.asarray(_w(9, (96, 40))), 8, None, 16)
    lo, hi = jnp.float32(-2.5), jnp.float32(4.0)
    qp = (symmetric_activation_qparams if symmetric
          else activation_qparams)(lo, hi, 8)
    jq = jqt.attach_act_qparams({"wq": jq}, {"wq": qp})["wq"]
    aq = QParams(torch.from_numpy(np.array(jq.act_qparams.scale)),
                 torch.from_numpy(np.array(jq.act_qparams.offset)),
                 jq.act_qparams.bits, jq.act_qparams.symmetric)
    corr = None if symmetric else torch.from_numpy(np.array(jq.act_corr))
    jx, tx = _x(10, "float32")
    _check(jx, tx, jq, _port_qt(jq, aq, corr), "sorted_tiled_seq",
           site="wq")


def test_site_overrides():
    cfg = td.IntegerLinConfig(site_policies=(("w_out", "wide"),),
                              site_acc_bits=(("wq", 24),))
    assert cfg.policy_for("w_out") == "wide"
    assert cfg.policy_for("wq") == "sorted_tiled_seq"
    assert cfg.acc_bits_for("wq") == 24 and cfg.acc_bits_for("wk") == 16


def test_integer_lin_context_routes_lin():
    from repro_torch.models.layers import lin

    jq = jqt.quantize_weight(jnp.asarray(_w(11, (96, 40))), 8, None, 16)
    tq_ = _port_qt(jq)
    _, tx = _x(12, "float32")
    deq = lin(tx, tq_)
    # outside the context: a float matmul; XLA and torch may sum it in
    # another order, so f32 rounding (~1e-6 relative) is allowed
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jax.device_get(
            jnp.asarray(tx.numpy()) @ jq.dequant(jnp.float32))),
        rtol=1e-5, atol=1e-5)
    with td.integer_lin(td.IntegerLinConfig(k_tile=32)) as cfg:
        got = lin(tx, tq_, site="wq")
    np.testing.assert_array_equal(got.numpy(),
                                  td.qtensor_dot(tx, tq_, cfg).numpy())
