"""Accumulator-aware training in the port against the JAX package:
``core/a2q``, the optimizers and the A2Q+ projection, ``a2q_qat_lin`` and
the ``lin`` hook, ``lm_loss`` / ``Model.loss``, ``a2q_finetune`` and
``quantize_and_certify``.

Bit-exact: the A2Q projection (integer weights, scales, row bounds,
violations, sparsity), ``a2q_fake_quant``'s forward, the census counts
of the QAT signal at step 0, and ``quantize_and_certify``'s integer
weights and per-site ``acc_bits_safe`` on converted JAX params. Within a
stated tolerance: the optimizers' updates, the soft-threshold projection
(a bisection whose comparisons may tie the other way), the QAT matmul,
the losses and the fine-tune's losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_to_port import to_numpy

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import a2q as ja2q
from repro.core import dispatch as jdispatch
from repro.core.quant import activation_qparams as jact_qparams
from repro.data import TokenStream as JTokenStream
from repro.models.model import build_model as jbuild_model
from repro.models.transformer import lm_loss as jlm_loss
from repro.optim import a2q as joa2q
from repro.runtime import qat as jqat
from repro_torch import optim as toptim
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import a2q as ta2q
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import qtensor as tqt
from repro_torch.core.quant import activation_qparams as tact_qparams
from repro_torch.data import TokenStream
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model
from repro_torch.models.transformer import lm_loss
from repro_torch.optim import a2q as toa2q
from repro_torch.runtime import qat as tqat

# float32 updates of the same arithmetic in another order
UPDATE_TOL = dict(rtol=2e-6, atol=1e-7)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ---------------------------------------------------------------------------
# core/a2q
# ---------------------------------------------------------------------------


def test_scalars_match_jax():
    for bits in (4, 8):
        assert ta2q.act_code_range(act_bits=bits) == \
            ja2q.act_code_range(act_bits=bits)
    assert ta2q.act_code_range() is None
    tq = tact_qparams(torch.tensor(-1.0), torch.tensor(3.0), 6)
    jq = jact_qparams(jnp.float32(-1.0), jnp.float32(3.0), 6)
    assert ta2q.act_code_range(tq) == ja2q.act_code_range(jq) == (-32, 31)
    for acc in (12, 16, 30):
        assert ta2q.a2q_acc_caps(acc) == ja2q.a2q_acc_caps(acc)
        for wb in (5, 8):
            assert ta2q.a2q_l1_bound(wb, acc) == ja2q.a2q_l1_bound(wb, acc)
            assert toa2q.a2q_l1_ratio(wb, acc, 8) == \
                joa2q.a2q_l1_ratio(wb, acc, 8)


@pytest.mark.parametrize("wb,ab,act,shape", [
    (8, 16, None, (32, 256)), (8, 12, None, (16, 512)),
    (5, 14, None, (32, 256)), (8, 16, 8, (24, 1536)), (8, 12, 4, (16, 96)),
    (4, 10, 8, (8, 40))])
def test_quantize_project_matches_jax(rng, wb, ab, act, shape):
    """wq, scale, row bounds, violations and sparsity bit for bit; the
    bound holds after projection (the symmetric L1 form, or the
    sign-split form against the activation range)."""
    w = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    w[0] = 0.0  # an all-zero row takes the 1e-8 floor
    jwq, jscale = ja2q.a2q_quantize_project(jnp.asarray(w), wb, ab,
                                            act_bits=act)
    twq, tscale = ta2q.a2q_quantize_project(torch.from_numpy(w), wb, ab,
                                            act_bits=act)
    np.testing.assert_array_equal(_np(twq), _np(jwq))
    np.testing.assert_array_equal(_np(tscale), _np(jscale))
    assert twq.dtype == torch.int32
    tpos, tneg = ta2q.a2q_row_bounds(twq, wb, act_bits=act)
    jpos, jneg = ja2q.a2q_row_bounds(jwq, wb, act_bits=act)
    np.testing.assert_array_equal(_np(tpos), _np(jpos))
    np.testing.assert_array_equal(_np(tneg), _np(jneg))
    assert int(ta2q.a2q_violations(twq, wb, ab, act_bits=act)) == \
        int(ja2q.a2q_violations(jwq, wb, ab, act_bits=act)) == 0
    loose = np.clip(np.round(w * 40), -127, 127).astype(np.int32)
    assert int(ta2q.a2q_violations(torch.from_numpy(loose), wb, ab,
                                   act_bits=act)) == \
        int(ja2q.a2q_violations(jnp.asarray(loose), wb, ab, act_bits=act))
    assert int((twq == 0).sum()) == int((jwq == 0).sum())
    assert float(ta2q.a2q_sparsity(twq)) == pytest.approx(
        float(ja2q.a2q_sparsity(jwq)), rel=1e-6)  # a float32 mean
    if act is None:
        assert (np.abs(_np(twq)).sum(-1) <= ta2q.a2q_l1_bound(wb, ab)).all()


def test_fake_quant_matches_jax(rng):
    """Forward bit for bit, symmetric and against a frozen activation
    range; the gradient is the identity (straight through)."""
    w = (rng.standard_normal((12, 64)) * 0.5).astype(np.float32)
    jq = jact_qparams(jnp.float32(-2.0), jnp.float32(5.0), 8)
    tq = tact_qparams(torch.tensor(-2.0), torch.tensor(5.0), 8)
    for kw_j, kw_t in (({}, {}), ({"act_qparams": jq}, {"act_qparams": tq})):
        want = ja2q.a2q_fake_quant(jnp.asarray(w), 8, 14, **kw_j)
        tw = torch.from_numpy(w).requires_grad_()
        got = ta2q.a2q_fake_quant(tw, 8, 14, **kw_t)
        np.testing.assert_array_equal(_np(got), _np(want))
        got.sum().backward()
        assert torch.equal(tw.grad, torch.ones_like(tw))


# ---------------------------------------------------------------------------
# optimizers and the projection
# ---------------------------------------------------------------------------


def _trees(rng):
    shapes = {"a": (8, 6), "b": (6,), "layers": [{"w": (4, 5)},
                                                 {"w": (4, 5)}]}

    def draw(node, scale=1.0):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v, scale) for v in node]
        return (rng.standard_normal(node) * scale).astype(np.float32)

    return draw(shapes), [draw(shapes, 3.0) for _ in range(3)]


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _assert_trees_close(got, want, **tol):
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        _np, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("name", ["adamw", "adamw_cosine", "sgd",
                                  "sgd_warmup", "adamw_projected"])
def test_optimizers_match_jax(rng, name):
    """Three updates of each optimizer on a nested tree (random gradients
    large enough for the global-norm clip): params and moments within
    UPDATE_TOL; weight decay on >= 2-D leaves only; the A2Q+ wrapper
    projects after the inner update and leaves the state alone."""
    params, grads = _trees(rng)

    def make(mod):
        if name == "adamw":
            return mod.adamw(lr=1e-2, weight_decay=0.1, max_grad_norm=1.0)
        if name == "adamw_cosine":
            return mod.adamw(lr=mod.cosine_schedule(1e-2, 10, 2),
                             max_grad_norm=None)
        if name == "sgd":
            return mod.sgd_momentum(lr=0.1, weight_decay=0.01,
                                    max_grad_norm=2.0)
        if name == "sgd_warmup":
            return mod.sgd_momentum(lr=mod.linear_warmup(0.1, 4))
        return mod.with_a2q_projection(mod.adamw(lr=1e-2), 8, 12, 8,
                                       min_dim=4)

    jopt, topt = make(joptim), make(toptim)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update(_to_jax(g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
        _assert_trees_close(tp, jp, **UPDATE_TOL)
    assert int(ts.step) == int(js.step) == 3
    _assert_trees_close(ts.mu, js.mu, **UPDATE_TOL)
    assert (ts.nu is None) == (js.nu is None)
    if ts.nu is not None:
        _assert_trees_close(ts.nu, js.nu, **UPDATE_TOL)
    tg = _to_torch(grads[0])
    np.testing.assert_allclose(float(toptim.global_norm(tg)),
                               float(joptim.optim.global_norm(
                                   _to_jax(grads[0]))), rtol=1e-6)
    clipped, norm = toptim.clip_by_global_norm(tg, 1.0)
    assert float(toptim.global_norm(clipped)) == pytest.approx(1.0, 1e-5)


def test_soft_threshold_rows_matches_jax(rng):
    """Within 1e-5 of each row's max magnitude (the bisection's
    comparisons may tie the other way); rows already inside the region
    pass through bit for bit."""
    ratio = toa2q.a2q_l1_ratio(8, 16, 8)  # about 2.016
    v = rng.standard_normal((20, 300)).astype(np.float32)
    v[3] = 0.0
    v[4, :] = 0.0
    v[4, :3] = (1.0, -0.5, 0.25)  # well inside the region
    got = toa2q._soft_threshold_rows(torch.from_numpy(v), ratio)
    want = joa2q._soft_threshold_rows(jnp.asarray(v), ratio)
    amax = np.abs(v).max(-1, keepdims=True)
    assert (np.abs(_np(got) - _np(want)) <= 1e-5 * amax + 1e-30).all()
    np.testing.assert_array_equal(_np(got)[3:5], v[3:5])
    g = np.abs(_np(got))[5:]  # two sweeps move rows toward the region
    assert (g.sum(-1) / g.max(-1) < np.abs(v[5:]).sum(-1) / amax[5:, 0]
            ).all()


# ---------------------------------------------------------------------------
# QAT at the linear sites, the loss and the fine-tune
# ---------------------------------------------------------------------------


def test_a2q_qat_lin_and_hook_match_jax(rng):
    """a2q_qat_lin's output within 1e-5 and its census report equal; the
    lin hook takes a named float matrix and leaves small and unnamed
    ones, and QTensors, as they were."""
    x = (rng.standard_normal((2, 3, 64)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.2).astype(np.float32)
    jcfg = jdispatch.QATQuantConfig(acc_bits=14, census_rows=4)
    tcfg = tdispatch.QATQuantConfig(acc_bits=14, census_rows=4)
    jmon, tmon = jdispatch.CensusMonitor(), tdispatch.CensusMonitor()
    with jdispatch.census_monitor(jmon):
        want = jdispatch.a2q_qat_lin(jnp.asarray(x), jnp.asarray(w), jcfg,
                                     site="wq")
        jax.effects_barrier()
    with tdispatch.census_monitor(tmon):
        got = tdispatch.a2q_qat_lin(torch.from_numpy(x), torch.from_numpy(w),
                                    tcfg, site="wq")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    assert tmon.totals() == jmon.totals() == {"wq": (4 * 48, 0)}
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with tdispatch.a2q_qat(tcfg), tdispatch.census_monitor(
            tdispatch.CensusMonitor()) as mon:
        assert torch.equal(tlayers.lin(tx, tw, site="wq"), got)
        assert torch.equal(tlayers.lin(tx, tw), tx @ tw)  # unnamed
        small = tw[:, :8]
        assert torch.equal(tlayers.lin(tx, small, site="wk"), tx @ small)
        qt = tqt.quantize_weight(tw, 8)
        assert torch.equal(tlayers.lin(tx, qt, site="wq"),
                           tx @ qt.dequant(tx.dtype))
    assert set(mon.totals()) == {"wq"}


def test_lm_loss_matches_jax(rng):
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, :2] = -1
    for aux in (0.0, 0.7):
        want = jlm_loss(jnp.asarray(logits), jnp.asarray(labels), aux)
        got = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      aux)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = -np.ones((1, 3), np.int32)
    assert float(lm_loss(torch.from_numpy(logits[:1, :3]),
                         torch.from_numpy(empty))) == pytest.approx(0.0)


@pytest.fixture(scope="module")
def smoke():
    """The smoke qwen2 in both packages (compute in float32) and the JAX
    params, the port's copy converted."""
    # remat off: a rematerialized JAX forward reports each census twice a
    # step (the forward runs again in the backward); the port runs it once
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32", remat=False)
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(
        get_config("qwen2-1.5b", smoke=True), compute_dtype="float32"),
        device="cpu")
    return jmodel, params, tmodel, params_from_numpy(to_numpy(params),
                                                     device="cpu")


def _stream(cls, cfg):
    return cls(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=3)


def test_model_loss_matches_jax(smoke):
    jmodel, jparams, tmodel, tparams = smoke
    batch = _stream(TokenStream, tmodel.cfg).next_batch()
    want = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    got = tmodel.loss(tparams, {k: torch.from_numpy(v) for k, v in
                                batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_a2q_finetune_matches_jax(smoke):
    """Three AdamW steps under a2q_qat from the same converted params:
    each step's loss within 1e-4 relative (float32 forwards in another
    order, through the projection's truncations), the census of every
    QAT site at step 0 equal, count for count, and the fine-tuned params
    within 2e-3 of the JAX package's."""
    jmodel, jparams, tmodel, tparams = smoke
    js, ts = _stream(JTokenStream, tmodel.cfg), _stream(TokenStream,
                                                        tmodel.cfg)
    cfg = dict(acc_bits=14, lr=1e-3, census_rows=4)
    jout, jhist = jqat.a2q_finetune(
        jmodel, jparams, lambda i: {k: jnp.asarray(v) for k, v in
                                    js.next_batch().items()}, 3,
        jqat.QATConfig(**cfg))
    tout, thist = tqat.a2q_finetune(tmodel, tparams,
                                    lambda i: ts.next_batch(), 3,
                                    tqat.QATConfig(**cfg))
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    assert thist[0]["census"] == jhist[0]["census"]
    assert set(thist[0]["census"]) == {"wq", "wk", "wv", "wo", "w_gate",
                                       "w_up", "w_out"}
    assert all(d > 0 for d, _ in thist[0]["census"].values())
    for h in thist:
        assert set(h["census_rates"]) == set(h["census"])
    want = params_from_numpy(to_numpy(jout), device="cpu")
    for got_l, want_l in zip(tout["layers"], want["layers"]):
        for key in ("wq", "w_up"):
            sec = "attn" if key == "wq" else "mlp"
            np.testing.assert_allclose(_np(got_l[sec][key]),
                                       _np(want_l[sec][key]), atol=2e-3)


def _qleaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _qleaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _qleaves(x, y, f"{path}/{i}")
    elif tqt.is_qtensor(a):
        yield path, a, b


@pytest.mark.parametrize("acc_bits,n_keep", [(16, None), (12, 8)])
def test_quantize_and_certify_matches_jax(smoke, acc_bits, n_keep):
    """On converted JAX float params: every integer weight and scale, and
    every site's acc_bits_safe, equal the JAX package's."""
    _, jparams, _, tparams = smoke
    jq, jc = jqat.quantize_and_certify(jparams, acc_bits, n_keep=n_keep)
    tq, tc = tqat.quantize_and_certify(tparams, acc_bits, n_keep=n_keep,
                                       device="cpu")
    want = params_from_numpy(to_numpy(jq), device="cpu")
    leaves = list(_qleaves(tq, want))
    assert leaves
    for path, g, w in leaves:
        assert torch.equal(g.values, w.values), path
        assert torch.equal(g.scale, w.scale), path
    assert {s.site: s.acc_bits_safe for s in tc.sites} == \
        {s.site: s.acc_bits_safe for s in jc.sites}
    assert all(s.acc_bits_safe <= acc_bits for s in tc.sites)
    tc.verify(tq)
