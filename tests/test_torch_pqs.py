"""The paper's own path in the port against the JAX package: the synthetic
data, the P->Q / Q->P schedules, QuantLinear, the paper nets and the
overflow-analysis entry point.

Bit-exact: the data arrays, the schedules and pruning masks, freeze's
integer weights and quantization parameters, the integer accumulator of
``quant_linear_int_fwd`` under all six policies (conv1's K = 36 below
k_tile included, 8-bit and 5-bit codes, asymmetric activation offsets),
the integer path's logits and ``evaluate_int``'s accuracy on converted
JAX layers, and the census counts. Within a stated tolerance: the float
forwards and gradients (float32 matmuls sum in another order), one
training step, and a short whole schedule started from the same converted
layers (its accuracy and the share of equal mask entries). The JAX
package's integer path runs as its own tests run it on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_to_port import frozen_layers, papernet_layers

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.configs import paper as jpaper
from repro.core import dispatch as jdispatch
from repro.core import papernets as jnets
from repro.core import pqs as jpqs
from repro.data import pipeline as jdata
from repro_torch.configs import paper as tpaper
from repro_torch.convert import (
    frozen_layers_from_numpy,
    papernet_layers_from_numpy,
)
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import papernets as tnets
from repro_torch.core import pqs as tpqs
from repro_torch.core.quant import quantize as tquantize
from repro_torch.data import pipeline as tdata

POLICIES = ("wide", "clip", "wrap", "sorted", "sorted_tiled",
            "sorted_tiled_seq")
# float32 forwards: the packages' matmuls sum K products in different
# orders, a few units in the last place a layer
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# after QAT fake quantization: a code may round the other way where a
# pre-activation lies within that error of a rounding boundary
QAT_TOL = dict(rtol=1e-3, atol=2e-3)


def _small(kind, **kw):
    """A paper-net config of each package (the published widths, or a
    narrower MLP for the gradient checks)."""
    name = {"mlp1": "MLP1", "mlp2": "MLP2", "convnet": "CONVNET"}[kind]
    return (dataclasses.replace(getattr(jpaper, name), **kw),
            dataclasses.replace(getattr(tpaper, name), **kw))


def _pqs(**kw):
    return jpqs.PQSConfig(**kw), tpqs.PQSConfig(**kw)


def _jax_layers(jcfg, seed, x=None, jpq=None, updates=2):
    """JAX init layers of a net, their observers updated on ``x``."""
    layers = jnets.init_papernet(jax.random.PRNGKey(seed), jcfg)
    for _ in range(updates if x is not None else 0):
        _, layers = jnets.papernet_fwd(layers, jnp.asarray(x), jcfg, jpq,
                                       quantizing=False)
    return layers


def _port_layers(jlayers):
    return papernet_layers_from_numpy(papernet_layers(jlayers), device="cpu")


def _data(n, seed):
    return jdata.synth_mnist(n, seed), tdata.synth_mnist(n, seed)


# ---------------------------------------------------------------------------
# data, configs, schedules
# ---------------------------------------------------------------------------


def test_data_arrays_match_jax():
    for n, seed in ((300, 0), (257, 3)):
        jd, td = _data(n, seed)
        np.testing.assert_array_equal(td.x, jd.x)
        np.testing.assert_array_equal(td.y, jd.y)
        (jtr, jte), (ttr, tte) = jd.split(0.9), td.split(0.9)
        np.testing.assert_array_equal(tte.x, jte.x)
        for (jx, jy), (tx, ty) in zip(jtr.batches(64, seed=5, epochs=2),
                                      ttr.batches(64, seed=5, epochs=2)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        assert len(list(ttr.batches(64, drop_remainder=False))) == \
            len(list(jtr.batches(64, drop_remainder=False)))
    jc = jdata.make_classification(200, 32, 5, seed=1, noise=0.5, subspace=4)
    tc = tdata.make_classification(200, 32, 5, seed=1, noise=0.5, subspace=4)
    np.testing.assert_array_equal(tc.x, jc.x)
    js = jdata.TokenStream(100, 8, 3, seed=2, host_id=1, num_hosts=2)
    ts = tdata.TokenStream(100, 8, 3, seed=2, host_id=1, num_hosts=2)
    for _ in range(3):
        jb, tb = js.next_batch(), ts.next_batch()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[key], jb[key])
    assert ts.state() == js.state()
    ts.restore({"step": 1})
    js.restore({"step": 1})
    np.testing.assert_array_equal(ts.next_batch()["tokens"],
                                  js.next_batch()["tokens"])


def test_configs_match_jax():
    for name in ("MLP1", "MLP2", "CONVNET"):
        j, t = getattr(jpaper, name), getattr(tpaper, name)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert td == jd
    tpqs.PQSConfig().validate()
    for bad in ({"acc_bits": 31}, {"policy": "bogus"}, {"order": "x"},
                {"weight_bits": 9}, {"rounds": 0}):
        with pytest.raises(AssertionError):
            jpqs.PQSConfig(**bad).validate()
        with pytest.raises(AssertionError):
            tpqs.PQSConfig(**bad).validate()
    assert tpqs.PQSConfig(n_keep=4, m=16).sparsity == 0.75


@pytest.mark.parametrize("order,total,every,frac,n_keep", [
    ("pq", 20, 2, 0.5, 8), ("pq", 30, 5, 0.7, 11), ("pq", 1, 1, 0.7, 8),
    ("qp", 10, 2, 0.9, 8), ("qp", 12, 3, 0.9, 4)])
def test_schedules_match_jax(order, total, every, frac, n_keep):
    jc, tc = _pqs(order=order, n_keep=n_keep, m=16)
    got = tpqs.build_schedule(tc, total, every, frac)
    want = jpqs.build_schedule(jc, total, every, frac)
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]
    assert [dataclasses.astuple(p) for p in tpqs.pq_schedule(
        tc, total, every, 3)] == [dataclasses.astuple(p) for p in
                                  jpqs.pq_schedule(jc, total, every, 3)]


@pytest.mark.parametrize("quantized_signal", [False, True])
@pytest.mark.parametrize("n_keep", [14, 8, 3])
def test_apply_prune_phase_matches_jax(rng, quantized_signal, n_keep):
    w = rng.standard_normal((24, 64)).astype(np.float32)
    w[:, 5] = w[:, 6]  # tied magnitudes: the lower index survives
    w[:, 9] = -w[:, 10]
    jc, tc = _pqs(weight_bits=4, n_keep=n_keep, m=16)
    phase = dict(epoch=3, quantizing=True, n_keep=n_keep)
    want = jpqs.apply_prune_phase({"w": jnp.asarray(w)},
                                  jpqs.Phase(**phase), jc, quantized_signal)
    got = tpqs.apply_prune_phase({"w": torch.from_numpy(w)},
                                 tpqs.Phase(**phase), tc, quantized_signal)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    none = tpqs.Phase(epoch=0, quantizing=False, n_keep=None)
    assert tpqs.apply_prune_phase({"w": 1}, none, tc, True) == {"w": 1}


# ---------------------------------------------------------------------------
# QuantLinear
# ---------------------------------------------------------------------------


def _observed_layer(rng, k, n, bits, n_keep=8):
    """A JAX layer whose observer saw two asymmetric batches, N:M-masked,
    and the port's copy of it."""
    jc, _ = _pqs(weight_bits=bits, act_bits=bits)
    layer = jpqs.quant_linear_init(jax.random.PRNGKey(k + n), k, n)
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((6, k)) * 0.7 + 0.3, jnp.float32)
        _, layer = jpqs.quant_linear_train_fwd(layer, x, jc, quantizing=True)
    if k % 16 == 0:
        from repro.core.pruning import nm_prune_mask

        layer["mask"] = nm_prune_mask(layer["w"], n_keep, 16)
    return layer, _port_layers([layer])[0]


# (K, N, M, bits, acc_bits): conv1 (K = 36 < k_tile), conv2, the heads and
# mlp1 at 8-bit codes; conv2 and the convnet head at 5-bit (w5a5)
INT_CASES = ((36, 16, 5, 8, 12), (144, 32, 7, 8, 14), (784, 10, 3, 8, 16),
             (512, 10, 3, 5, 11))


@pytest.mark.parametrize("k,n,m,bits,acc", INT_CASES)
def test_freeze_and_integer_path_match_jax(rng, k, n, m, bits, acc):
    """freeze: wq and both QParams bit for bit; the integer accumulator
    and the dequantized output of quant_linear_int_fwd bit for bit under
    every policy; the census counts equal."""
    jl, tl = _observed_layer(rng, k, n, bits)
    jc, tc = _pqs(weight_bits=bits, act_bits=bits, acc_bits=acc)
    jf, tf = jpqs.quant_linear_freeze(jl, jc), tpqs.quant_linear_freeze(tl,
                                                                        tc)
    np.testing.assert_array_equal(tf["wq"].numpy(), np.asarray(jf["wq"]))
    for qp in ("w_qp", "x_qp"):
        assert tf[qp].scale.item() == float(jf[qp].scale), qp
        assert tf[qp].offset.item() == int(jf[qp].offset), qp
        assert (tf[qp].bits, tf[qp].symmetric) == (jf[qp].bits,
                                                    jf[qp].symmetric)
    assert int(jf["x_qp"].offset) != 0  # asymmetric activations
    # frozen layers carried across equal the port's own freeze
    carried = frozen_layers_from_numpy(frozen_layers([jf]), device="cpu")[0]
    assert torch.equal(carried["wq"], tf["wq"])
    x = (rng.standard_normal((m, k)) * 0.8 + 0.2).astype(np.float32)
    xq = tquantize(torch.from_numpy(x), tf["x_qp"])
    for policy in POLICIES:
        jp = dataclasses.replace(jc, policy=policy)
        tp = dataclasses.replace(tc, policy=policy)
        want = jpqs.quant_linear_int_fwd(jf, jnp.asarray(x), jp)
        got = tpqs.quant_linear_int_fwd(tf, torch.from_numpy(x), tp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=policy)
        kw = dict(acc_bits=acc, policy=policy, k_tile=256, rounds=2,
                  batch_chunk=128)
        zj = jdispatch.pqs_dot(jnp.asarray(xq.numpy()), jf["wq"], **kw)
        zt = tdispatch.pqs_dot(xq, tf["wq"], **kw)
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj),
                                      err_msg=policy)
    cj = jpqs.quant_linear_census(jf, jnp.asarray(x), jc)
    ct = tpqs.quant_linear_census(tf, torch.from_numpy(x), tc)
    for key in ("n_dots", "n_persistent", "n_transient", "n_any"):
        assert int(getattr(ct, key)) == int(getattr(cj, key)), key


def test_train_fwd_and_gradients_match_jax(rng):
    """quant_linear_train_fwd through a two-layer chain under QAT: the
    outputs, the observers and the gradients of w and b (through the
    weight scale's amax and the observer bounds into the clip limits)
    within FWD_TOL."""
    jcfg, tcfg = _small("mlp2", in_dim=64, hidden=48)
    jc, tc = _pqs()
    x = (rng.standard_normal((16, 64)) * 0.6 + 0.1).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    jl = _jax_layers(jcfg, 3, x, jc)
    tl = _port_layers(jl)

    def jloss(ls):
        logits, _ = jnets.papernet_fwd(ls, jnp.asarray(x), jcfg, jc, True)
        return jnets.ce_loss(logits, jnp.asarray(y))

    jg = jax.jit(jax.grad(jloss))(jl)
    for l in tl:
        l["w"].requires_grad_()
        l["b"].requires_grad_()
    logits, new = tnets.papernet_fwd(tl, torch.from_numpy(x), tcfg, tc, True)
    jlogits, jnew = jnets.papernet_fwd(jl, jnp.asarray(x), jcfg, jc, True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **FWD_TOL)
    tnets.ce_loss(logits, torch.from_numpy(y)).backward()
    for i in range(2):
        for key in ("lo", "hi"):
            np.testing.assert_allclose(
                getattr(new[i]["act_range"], key).detach().numpy(),
                np.asarray(getattr(jnew[i]["act_range"], key)), **FWD_TOL)
        assert new[i]["act_range"].n == float(jnew[i]["act_range"].n)
        for key in ("w", "b"):
            np.testing.assert_allclose(tl[i][key].grad.numpy(),
                                       np.asarray(jg[i][key]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{i} {key}")


# ---------------------------------------------------------------------------
# the paper nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,cin", [(14, 4), (7, 16), (6, 3)])
def test_img_patches_match_jax(rng, hw, cin):
    x = rng.standard_normal((3, hw * hw * cin)).astype(np.float32)
    want, oh, ow = jnets._img_patches(jnp.asarray(x), hw, cin)
    got, toh, tow = tnets._img_patches(torch.from_numpy(x), hw, cin)
    assert (toh, tow) == (oh, ow)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["mlp1", "mlp2", "convnet"])
def test_float_forward_matches_jax(kind):
    jcfg, tcfg = _small(kind)
    jd, _ = _data(40, 1)
    jc, tc = _pqs()
    jl = _jax_layers(jcfg, 0, jd.x[:20], jc)
    tl = _port_layers(jl)
    assert [tuple(l["w"].shape) for l in tl] == \
        [tuple(l["w"].shape) for l in jl]
    assert len(tl) == len(tnets.pqs_layer_mask(tcfg))
    for quantizing, tol in ((False, FWD_TOL), (True, QAT_TOL)):
        want, _ = jnets.papernet_fwd(jl, jnp.asarray(jd.x[20:]), jcfg, jc,
                                     quantizing)
        got, _ = tnets.papernet_fwd(tl, torch.from_numpy(jd.x[20:]), tcfg,
                                    tc, quantizing)
        assert tuple(got.shape) == (20, 10)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)
    gen = torch.Generator().manual_seed(0)
    drawn = tnets.init_papernet(gen, tcfg)
    assert [l["w"].shape for l in drawn] == [l["w"].shape for l in tl]


def _assert_layers_close(got, want, tol):
    for g, w in zip(got, want):
        for key in ("w", "b"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]),
                                       **tol)
        np.testing.assert_allclose(g["act_range"].hi.numpy(),
                                   np.asarray(w["act_range"].hi), **tol)
        assert g["act_range"].n == float(w["act_range"].n)


@pytest.mark.parametrize("kind,order,fp32_frac,a2q", [
    ("mlp2", "pq", 1.0, None), ("mlp2", "qp", 0.7, None),
    ("convnet", "pq", 0.0, None), ("mlp1", "pq", 0.0, 12)])
def test_one_training_step_matches_jax(kind, order, fp32_frac, a2q):
    """One SGD step (144 samples: one batch of 128) from the same
    converted layers: float32 (fp32_frac 1), QAT, and the A2Q regime
    whose update lands on the projected weights. Float32 steps agree to
    rtol 1e-4 / atol 1e-5. A first QAT step puts an activation range's
    clip limit at its batch max (the observer has seen one batch), so
    whether that element's gradient passes the clip turns on the last
    place of a float32 matmul: one channel's update may differ by up to
    lr times its share of one element's gradient (atol 2e-5 here)."""
    jcfg, tcfg = _small(kind)
    jd, td = _data(144, 7)
    jc, tc = _pqs(order=order)
    kw = dict(epochs=1, batch=128, lr=0.05, prune_every=5,
              fp32_frac=fp32_frac, a2q_acc_bits=a2q, seed=4)
    want = jnets.train_papernet(jcfg, jc, jd, **kw)
    start = _port_layers(jnets.init_papernet(jax.random.PRNGKey(4), jcfg))
    got = tnets.train_papernet(tcfg, tc, td, layers=start, device="cpu", **kw)
    _assert_layers_close(got.layers, want.layers, dict(
        rtol=1e-4, atol=1e-5 if fp32_frac == 1.0 else 2e-5))
    assert got.history[0][0] == want.history[0][0]
    np.testing.assert_allclose(got.history[0][1], want.history[0][1],
                               rtol=1e-5)
    assert got.fp32_acc == pytest.approx(want.fp32_acc, abs=1 / 15)


@pytest.mark.parametrize("kind,order,epochs,n", [
    ("mlp1", "pq", 6, 1024), ("mlp2", "qp", 3, 512)])
def test_short_schedule_matches_jax(kind, order, epochs, n):
    """A whole P->Q (mlp1) or Q->P (mlp2) schedule from the same converted
    layers: each epoch's last loss within 2 %, the float32 accuracy within
    0.03 and at least 98 % of the mask entries equal (a prune decision
    may flip where two magnitudes in a group lie within the float
    error)."""
    jcfg, tcfg = _small(kind)
    jd, td = _data(n, 2)
    jc, tc = _pqs(n_keep=8, m=16, order=order)
    kw = dict(epochs=epochs, prune_every=1 if order == "qp" else 2,
              fp32_frac=0.75, lr=0.1, seed=1)
    want = jnets.train_papernet(jcfg, jc, jd, **kw)
    start = _port_layers(jnets.init_papernet(jax.random.PRNGKey(1), jcfg))
    got = tnets.train_papernet(tcfg, tc, td, layers=start, device="cpu", **kw)
    assert [e for e, _ in got.history] == [e for e, _ in want.history]
    np.testing.assert_allclose([v for _, v in got.history],
                               [v for _, v in want.history], rtol=0.02)
    assert abs(got.fp32_acc - want.fp32_acc) <= 0.03
    mask, jmask = got.layers[0]["mask"].numpy(), np.asarray(
        want.layers[0]["mask"])
    assert (mask == jmask).mean() >= 0.98
    assert (mask == 0).mean() == (jmask == 0).mean()  # the same N:M keep
    if kind == "mlp1":
        assert got.fp32_acc > 0.8  # the JAX test's bar


@pytest.mark.parametrize("kind,acc", [("mlp1", 16), ("mlp2", 14),
                                      ("convnet", 12)])
def test_integer_path_matches_jax(kind, acc):
    """On converted JAX layers: the integer path's logits bit for bit
    under each policy evaluate_int is asked for, and its accuracy equal;
    overflow_profile's census counts equal at 12 and 16 bits."""
    jcfg, tcfg = _small(kind)
    jd, td = _data(60, 5)
    jc, tc = _pqs()
    jl = _jax_layers(jcfg, 2, jd.x[:32], jc, updates=3)
    jl = [jpqs.apply_prune_phase(l, jpqs.Phase(0, True, 8), jc, False)
          if keep else l for l, keep in zip(jl, jnets.pqs_layer_mask(jcfg))]
    tl = _port_layers(jl)
    jf, tf = jnets.freeze_net(jl, jcfg, jc), tnets.freeze_net(tl, tcfg, tc)
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a["wq"].numpy(), np.asarray(b["wq"]))
    x = jd.x[:12]
    for policy in ("wide", "clip", "sorted", "sorted_tiled"):
        want, _ = jnets.papernet_fwd(jl, jnp.asarray(x), jcfg, jc, False,
                                     int_path=True, frozen=jf,
                                     policy=policy, acc_bits=acc)
        got, _ = tnets.papernet_fwd(tl, torch.from_numpy(x), tcfg, tc,
                                    False, int_path=True, frozen=tf,
                                    policy=policy, acc_bits=acc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=policy)
    assert tnets.evaluate_int(tl, tcfg, tc, td, "sorted", acc, limit=12) \
        == jnets.evaluate_int(jl, jcfg, jc, jd, "sorted", acc, limit=12)
    for acc in (12, 16):
        cj = jnets.overflow_profile(jl, jcfg, jc, jd, acc, limit=16)
        ct = tnets.overflow_profile(tl, tcfg, tc, td, acc, limit=16)
        assert [int(v) for v in ct[:4]] == [int(v) for v in cj[:4]]


def test_overflow_analysis_entry_point(capsys):
    """``python -m repro_torch.overflow_analysis --device cpu`` prints the
    JAX example's Fig-2 table: persistent overflows fall as the register
    widens, sorting never loses to clipping at the widest rows, and the
    wide register matches the float32 accuracy."""
    from repro_torch import overflow_analysis

    rows = overflow_analysis.main("cpu")
    out = capsys.readouterr().out
    assert "bits  persist  transnt  clip-all    sort    wide" in out
    assert [r["bits"] for r in rows] == list(overflow_analysis.BITS)
    persist = [r["persistent"] for r in rows]
    assert persist == sorted(persist, reverse=True)
    assert rows[-1]["sort"] >= rows[-1]["clip"]
    fp32 = float(out.split("fp32 accuracy: ")[1].split()[0])
    assert all(abs(r["wide"] - fp32) < 0.08 for r in rows)
