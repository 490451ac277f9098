"""The port's MoE family (granite-moe) and SSM family (mamba2) against the
JAX package, and the compute-dtype cast of per-layer vectors.

Parameters come from the JAX init (float32 compute unless a test says
bfloat16), quantized as ``tests/test_torch_families.py`` quantizes them
(8:16 int8, ``min_size`` 4096, ``min_dim`` 16: the experts, attention
and Mamba2's projections and the tied table), and reach the port as
numpy arrays through ``repro_torch.convert.params_from_numpy``.

The JAX package cannot serve MoE experts from dense int8 storage: its
``QTensor.dequant`` multiplies (E, d, ff) codes by an (E, ff) scale,
which does not broadcast. Its compressed storage does, with the same
values elementwise, so the JAX side of every quantized MoE comparison
serves the compressed tree, and the port serves both of its storages.

Tolerances:
- float32 logits agree to atol 1e-4 (``ATOL``): the same float32
  operations summed in another order move the last bits;
- routing (expert indices, capacity, arrival positions) is exact, gates
  and the aux loss agree to 1e-6;
- integer sites: every ``pqs_dot`` call's activation codes and integer
  dot are recorded in both packages and must be equal, downstream of the
  float reductions (the experts' einsums, the SSD) too: at these sizes
  no code lands on the other side of a rounding boundary (a code off by
  1 there would be a float-order difference, not a fault of the integer
  path). The logits then agree to ``ATOL`` as well. End to end the check
  is identical greedy tokens.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_to_port import to_numpy

from repro.configs import get_config as jget_config
from repro.core import certify as jcertify
from repro.core import dispatch as jd
from repro.core import qtensor as jqt
from repro.models import model as jmodel_lib
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild_model
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import certificate_from_fields, params_from_numpy
from repro_torch.core import certify as tcertify
from repro_torch.core import dispatch as td
from repro_torch.core import qtensor as tqt
from repro_torch.models import model as tmodel_lib
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine

ATOL = 1e-4
ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m", "mamba2-2.7b")


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _quantize(params):
    return jqt.quantize_tree(params, bits=8, n_keep=8, m=16,
                             min_size=1 << 12, min_dim=16)


def _port(tree):
    return params_from_numpy(to_numpy(tree), device="cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, JAX model, JAX float / quantized / compressed params, port
    model, the port's three trees converted from them)."""
    arch = request.param
    jmodel = jbuild_model(_f32(jget_config(arch, smoke=True)))
    fparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    # eager: jitted, XLA divides by qmax as a multiply by its reciprocal
    qparams = _quantize(fparams)
    cparams = jqt.nm_compress_tree(qparams, 8, 16)
    tmodel = build_model(_f32(get_config(arch, smoke=True)), device="cpu")
    return dict(arch=arch, jmodel=jmodel, jf=fparams, jq=qparams,
                jc=cparams, tmodel=tmodel, tf=_port(fparams), tq=_port(qparams),
                tc=_port(cparams))


def _jax_int_tree(fam):
    """The JAX tree a quantized comparison serves: compressed for MoE (its
    dense experts do not dequantize), dense otherwise."""
    return fam["jc"] if fam["tmodel"].cfg.moe is not None else fam["jq"]


def _int_ctx(jax_side):
    if jax_side:
        return jd.integer_lin(jd.IntegerLinConfig(
            policy="sorted_tiled_seq", acc_bits=16, k_tile=16,
            backend="jnp"))
    return td.integer_lin(td.IntegerLinConfig(
        policy="sorted_tiled_seq", acc_bits=16, k_tile=16))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _fields(cfg):
    return {f.name: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                     else v)
            for f in dataclasses.fields(ModelConfig)
            for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_jax_and_validate(arch):
    """Full and smoke configs: every port field (``moe`` and ``ssm`` field
    by field) equals the JAX package's, and ``validate`` accepts them."""
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke), jget_config(arch, smoke)
        assert _fields(cfg) == _fields(jcfg)
        cfg.validate()


def test_moe_on_a_dense_config_builds_moe_layers():
    """The JAX package builds MoE layers wherever ``moe`` is set, whatever
    the family; so does the port, and the float logits agree."""
    jcfg = _f32(jget_config("qwen2-1.5b", smoke=True),
                moe=jget_config("granite-moe-1b-a400m", smoke=True).moe)
    cfg = _f32(get_config("qwen2-1.5b", smoke=True),
               moe=get_config("granite-moe-1b-a400m", smoke=True).moe)
    jmodel = jbuild_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    tmodel = build_model(cfg, device="cpu")
    tparams = _port(params)
    assert "moe" in tparams["layers"][0] and "mlp" not in tparams["layers"][0]
    toks = _tokens(cfg.vocab_size, (2, 16), 1)
    jl = np.asarray(jmodel.forward(params, {"tokens": jnp.asarray(toks)}))
    tl = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)}).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# MoE: routing and dispatch
# ---------------------------------------------------------------------------


def _moe_layer(arch="granite-moe-1b-a400m", seed=0, **mkw):
    """(cfg, JAX layer-0 MoE params, the port's) of the smoke config."""
    jcfg = _f32(jget_config(arch, smoke=True))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **mkw))
    cfg = _f32(get_config(arch, smoke=True))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **mkw))
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jcfg.moe)
    return jcfg, cfg, jp, _port(jp)


@pytest.mark.parametrize("seed", [0, 1])
def test_route_capacity_positions(seed):
    jcfg, cfg, jp, tp = _moe_layer(seed=seed)
    x = np.random.default_rng(seed).standard_normal((3, 24, cfg.d_model)) \
        .astype(np.float32)
    ji, jg, ja = jax.jit(lambda x, w: jmoe.route(x, w, jcfg.moe))(
        jnp.asarray(x), jp["router"])
    ti, tg, ta = tmoe.route(torch.from_numpy(x), tp["router"], cfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-6
    for t in (1, 7, 24, 100):
        assert tmoe.capacity(t, cfg.moe) == jmoe.capacity(t, jcfg.moe)
    np.testing.assert_array_equal(
        tmoe._positions_in_expert(ti[0], cfg.moe.num_experts).numpy(),
        np.asarray(jmoe._positions_in_expert(ji[0], jcfg.moe.num_experts)))


@pytest.mark.parametrize("path", ["grouped", "per_token", "dense"])
def test_moe_ffn_paths(path):
    """Each dispatch path against the JAX package's on 2 x 24 tokens at
    capacity factor 0.5, where the grouped path drops assignments
    (capacity 6 of 12 a group's mean load)."""
    jcfg, cfg, jp, tp = _moe_layer(capacity_factor=0.5)
    x = np.random.default_rng(3).standard_normal((2, 24, cfg.d_model)) \
        .astype(np.float32)
    fns = {"grouped": (jmoe._moe_ffn_grouped, tmoe.moe_ffn),
           "per_token": (jmoe.moe_ffn_per_token, tmoe.moe_ffn_per_token),
           "dense": (jmoe.moe_ffn_dense, tmoe.moe_ffn_dense)}[path]
    jo, ja = jax.jit(lambda p, x: fns[0](p, x, jcfg, jcfg.moe))(
        jp, jnp.asarray(x))
    to, ta = fns[1](tp, torch.from_numpy(x), cfg, cfg.moe)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-6
    if path == "grouped":
        idx, _, _ = tmoe.route(torch.from_numpy(x), tp["router"], cfg.moe)
        pos = tmoe._positions_in_expert(idx, cfg.moe.num_experts)
        assert bool((pos >= tmoe.capacity(24, cfg.moe)).any())  # drops


def test_moe_dispatch_equals_dense_oracle_without_drops():
    """At capacity factor E / k nothing drops: the grouped dispatch
    equals the dropless oracle in the port."""
    _, cfg, _, tp = _moe_layer(capacity_factor=2.0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    ref, _ = tmoe.moe_ffn_dense(tp, x, cfg, cfg.moe)
    out, _ = tmoe.moe_ffn(tp, x, cfg, cfg.moe)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# SSM: the conv, the chunked SSD and the block
# ---------------------------------------------------------------------------


def _ssm_layer(seed=0):
    jcfg = _f32(jget_config("mamba2-2.7b", smoke=True))
    cfg = _f32(get_config("mamba2-2.7b", smoke=True))
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, _port(jp)


def test_causal_conv():
    r = np.random.default_rng(5)
    xbc = r.standard_normal((2, 13, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    j = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    t = tssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                          torch.from_numpy(b))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def _ssd_inputs(seed, b=2, length=64, h=4, p=8, g=2, n=8):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((b, length, h)))).astype(
        np.float32)
    a = -np.exp(r.uniform(0, 1.5, h)).astype(np.float32)
    bm = r.standard_normal((b, length, g, n)).astype(np.float32)
    cm = r.standard_normal((b, length, g, n)).astype(np.float32)
    h0 = r.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_chunked(chunk):
    """Several chunks and one; a carried-in state h0."""
    args = _ssd_inputs(6)
    jy, jf = jax.jit(lambda x, dt, a, b, c, h0: jssm._ssd_chunked(
        x, dt, a, b, c, chunk, h0))(*map(jnp.asarray, args))
    ty, tf = tssm._ssd_chunked(*map(torch.from_numpy, args[:5]), chunk,
                               torch.from_numpy(args[5]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-4)
    with pytest.raises(AssertionError):
        tssm._ssd_chunked(*map(torch.from_numpy, args[:5]), 24)


def test_ssd_chunked_equals_stepwise_recurrence():
    """The port's dual form over 4 chunks equals the plain recurrence h_t
    = exp(dt a) h_{t-1} + dt x (x) B, y_t = h_t C, one token at a time."""
    x, dt, a, bm, cm, h0 = map(torch.from_numpy, _ssd_inputs(7))
    y, final = tssm._ssd_chunked(x, dt, a, bm, cm, 16, h0)
    rep = x.shape[2] // bm.shape[2]
    bh = torch.repeat_interleave(bm, rep, dim=2)
    ch = torch.repeat_interleave(cm, rep, dim=2)
    state, ys = h0.clone(), []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t] * a)
        state = da[:, :, None, None] * state + (dt[:, t, :, None] * x[:, t])[
            ..., None] * bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=0, atol=1e-4)
    torch.testing.assert_close(final, state, rtol=0, atol=1e-4)


def test_mamba_forward_with_lengths():
    """Lanes of 64, 20, 2 (shorter than d_conv - 1 = 3) and 0 tokens: the
    outputs, final states and conv rings equal the JAX package's."""
    jcfg, cfg, jp, tp = _ssm_layer()
    x = np.random.default_rng(8).standard_normal((4, 64, cfg.d_model)) \
        .astype(np.float32)
    lengths = np.array([64, 20, 2, 0], np.int32)
    jo, jc = jax.jit(lambda p, x, n: jssm.mamba_forward(
        p, x, jcfg, lengths=n))(jp, jnp.asarray(x), jnp.asarray(lengths))
    to, tc = tssm.mamba_forward(tp, torch.from_numpy(x), cfg,
                                lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    for key in ("ssd", "conv"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=0, atol=1e-5)
    assert not tc["conv"][3].any() and not tc["conv"][2][0].any()
    assert tc["conv"][2][1:].abs().sum() > 0
    assert tc["ssd"].dtype == torch.float32


def test_mamba_forward_equals_steps_in_port():
    """The chunked block over 64 tokens (2 chunks of 32) equals 64
    ``mamba_step`` calls: outputs and the final state."""
    _, cfg, _, tp = _ssm_layer(1)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    full, final = tssm.mamba_forward(tp, x, cfg)
    cache = tssm.empty_ssm_cache(cfg, 2, torch.float32)
    outs = []
    for t in range(64):
        o, cache = tssm.mamba_step(tp, x[:, t : t + 1], cache, cfg)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=0, atol=1e-5)
    torch.testing.assert_close(cache["ssd"], final, rtol=0, atol=1e-5)


def test_softplus_is_jax_form():
    # (softplus(-100) is a denormal, which XLA's CPU flushes to zero)
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 20.0, 21.0, 50.0],
                 np.float32)
    np.testing.assert_array_equal(
        tssm.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# conversion and quantization
# ---------------------------------------------------------------------------


def _walk_equal(got, want, path=()):
    """Port trees leaf for leaf: QTensor / SparseQTensor arrays and float
    tensors equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _walk_equal(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _walk_equal(a, b, path + (i,))
    elif tqt.is_qtensor(want):
        assert type(got) is type(want), path
        for f in ("values", "scale") + (
                ("indices",) if isinstance(want, tqt.SparseQTensor) else ()):
            assert torch.equal(getattr(got, f), getattr(want, f)), (path, f)
    else:
        assert isinstance(got, torch.Tensor) and torch.equal(got, want), path


def test_conversion_layout(family):
    """Expert stacks: dense (E, d, ff) codes with (E, ff) scales and no
    transposed copy, compressed (E, ff, G, n_keep) slabs; the router and
    the SSM's vectors float; each layer's slice of the JAX leaf."""
    cfg = family["tmodel"].cfg
    for i, (lq, lc) in enumerate(zip(family["tq"]["layers"],
                                     family["tc"]["layers"])):
        if cfg.moe is not None:
            m = cfg.moe
            jmoe_q = family["jq"]["layers"]["moe"]
            wg = lq["moe"]["w_gate"]
            assert isinstance(wg, tqt.QTensor) and wg.values_t is None
            assert tuple(wg.values.shape) == (m.num_experts, cfg.d_model,
                                              m.d_ff)
            assert tuple(wg.scale.shape) == (m.num_experts, m.d_ff)
            np.testing.assert_array_equal(
                wg.values.numpy(), np.asarray(jmoe_q["w_gate"].values[i]))
            sg = lc["moe"]["w_gate"]
            assert isinstance(sg, tqt.SparseQTensor)
            assert tuple(sg.values.shape) == (m.num_experts, m.d_ff,
                                              cfg.d_model // 16, 8)
            assert isinstance(lq["moe"]["router"], torch.Tensor)
            assert isinstance(lq["attn"]["wq"].values_t, torch.Tensor)
        else:
            jl = family["jq"]["layers"]["mamba"]
            for key in ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                        "out_norm"):
                np.testing.assert_array_equal(lq["mamba"][key].numpy(),
                                              np.asarray(jl[key][i]))
            assert isinstance(lq["mamba"]["in_proj"], tqt.QTensor)
            assert isinstance(lc["mamba"]["in_proj"], tqt.SparseQTensor)


def test_port_quantize_tree_matches_jax(family):
    """The port's ``quantize_tree`` and ``nm_compress_tree`` on the
    converted float tree give the JAX package's leaves (the experts per
    matrix, a scale per expert column)."""
    kw = dict(bits=8, n_keep=8, m=16, min_size=1 << 12, min_dim=16)
    got = tqt.quantize_tree(family["tf"], device="cpu", **kw)
    _walk_equal(got, family["tq"])
    _walk_equal(tqt.nm_compress_tree(got, 8, 16), family["tc"])


@pytest.mark.parametrize("family", ARCHS[:2], indirect=True)
def test_expert_dequant_alike_across_storages(family):
    """Dense and compressed expert stacks dequantize to the same values,
    elementwise; the compressed ones to the JAX package's."""
    for i, (lq, lc) in enumerate(zip(family["tq"]["layers"],
                                     family["tc"]["layers"])):
        for key in ("w_gate", "w_up", "w_out"):
            dq = lq["moe"][key].dequant(torch.float32)
            assert torch.equal(dq, lc["moe"][key].dequant(torch.float32))
            jc = family["jc"]["layers"]["moe"][key]
            want = jqt.SparseQTensor(jc.values[i], jc.indices[i],
                                     jc.scale[i], jc.m_group, jc.k_dim)
            np.testing.assert_array_equal(
                dq.numpy(), np.asarray(want.dequant(jnp.float32)))


# ---------------------------------------------------------------------------
# the models against the JAX package
# ---------------------------------------------------------------------------


def test_forward_logits(family):
    """Float logits, and the MoE aux loss."""
    jmodel, tmodel = family["jmodel"], family["tmodel"]
    toks = _tokens(tmodel.cfg.vocab_size, (2, 32), 3)
    jl = np.asarray(jmodel.forward(family["jf"], {"tokens": jnp.asarray(
        toks)}))
    tl = tmodel.forward(family["tf"], {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ATOL)
    if tmodel.cfg.moe is not None:
        from repro.models import transformer as jtransformer
        from repro_torch.models import transformer as ttransformer

        _, ja = jtransformer.forward(family["jf"], jnp.asarray(toks), None,
                                     jmodel.cfg)
        _, ta = ttransformer.forward(family["tf"], torch.from_numpy(toks),
                                     None, tmodel.cfg)
        assert float(ta) > 0 and abs(float(ta) - float(ja)) <= 1e-6


@contextlib.contextmanager
def _sites(dispatch, jax_side):
    """Every ``pqs_dot`` call inside the context as (activation codes,
    integer dot) int64 arrays (M, K) and (M, N), in call order."""
    calls, orig = [], dispatch.pqs_dot

    def keep(x, o):
        x, o = np.asarray(x, np.int64), np.asarray(o, np.int64)
        calls.append((x.reshape(-1, x.shape[-1]), o.reshape(-1, o.shape[-1])))

    def call(x, w, **kw):
        out = orig(x, w, **kw)
        if jax_side:
            jax.debug.callback(keep, x, out, ordered=True)
        else:
            keep(x.numpy(), out.numpy())
        return out

    dispatch.pqs_dot = call
    try:
        yield calls
    finally:
        dispatch.pqs_dot = orig


def _prefill_decode(model, params, toks, lengths, nxt, jax_side, integer,
                    steps):
    cast = jnp.asarray if jax_side else torch.from_numpy
    dt = jnp.float32 if jax_side else torch.float32
    caches = model.init_caches(params, toks.shape[0], 64, dt)
    out = []
    ctx = _int_ctx(jax_side) if integer else contextlib.nullcontext()
    with ctx:
        # the integer JAX side eager, as the JAX package's tests run it
        prefill, decode = ((jax.jit(model.prefill), jax.jit(model.decode))
                           if jax_side and not integer
                           else (model.prefill, model.decode))
        lp, caches = prefill(params, cast(toks), caches, cast(lengths))
        out.append(lp)
        for t in range(steps):
            ld, caches = decode(params, cast(nxt[:, t : t + 1]), caches)
            out.append(ld)
    return [np.asarray(o) if jax_side else o.numpy() for o in out]


@pytest.mark.parametrize("integer,storage", [(False, "float"),
                                             (True, "dense"),
                                             (True, "nm")])
def test_prefill_then_decode(family, integer, storage):
    """A batched prefill of 64-token lanes (40, 21, 2 and 0 tokens; two SSD
    chunks at the smoke chunk of 32), then 2 decodes. Integer:
    ``sorted_tiled_seq`` at k_tile 16, every site recorded."""
    jmodel, tmodel = family["jmodel"], family["tmodel"]
    steps, vocab = 2, tmodel.cfg.vocab_size
    toks = _tokens(vocab, (4, 64), 1)
    lengths = np.array([40, 21, 2, 0], np.int32)
    nxt = _tokens(vocab, (4, steps), 2)
    jparams = _jax_int_tree(family) if integer else family["jf"]
    tparams = {"float": family["tf"], "dense": family["tq"],
               "nm": family["tc"]}[storage]
    with (_sites(jd, True) if integer else contextlib.nullcontext([])) as js:
        jl = _prefill_decode(jmodel, jparams, toks, lengths, nxt, True,
                             integer, steps)
    with (_sites(td, False) if integer else contextlib.nullcontext([])) as ts:
        tl = _prefill_decode(tmodel, tparams, toks, lengths, nxt, False,
                             integer, steps)
    for j, t in zip(jl, tl):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    if integer:
        # every quantized projection of every layer (the experts are float
        # einsums on dequantized weights)
        per_pass = sum(tqt.is_qtensor(w) for layer in tparams["layers"]
                       for part in ("attn", "mamba") if part in layer
                       for name, w in layer[part].items()
                       if name.startswith("w") or name.endswith("_proj"))
        assert per_pass and len(ts) == len(js) == (1 + steps) * per_pass
        for i, ((jx, jo), (tx, to)) in enumerate(zip(js, ts)):
            np.testing.assert_array_equal(tx, jx, err_msg=f"codes, call {i}")
            np.testing.assert_array_equal(to, jo, err_msg=f"dot, call {i}")


def test_engine_greedy_tokens(family):
    """5 requests on 3 slots under ``sorted_tiled_seq``: the JAX engine's
    greedy tokens, from both of the port's storages."""
    jmodel, tmodel = family["jmodel"], family["tmodel"]
    vocab = tmodel.cfg.vocab_size

    def reqs(cls):
        return [cls(uid=i, prompt=_tokens(vocab, (n,), 10 + i),
                    max_new_tokens=8)
                for i, n in enumerate((40, 6, 24, 2, 1))]

    jeng = JServingEngine(jmodel, _jax_int_tree(family), num_slots=3,
                          max_len=64, int_lin=jd.IntegerLinConfig(
                              policy="sorted_tiled_seq", acc_bits=16,
                              k_tile=16, backend="jnp"))
    jr = reqs(JRequest)
    jeng.drain(jr)
    for storage in ("tq", "tc"):
        eng = ServingEngine(tmodel, family[storage], num_slots=3, max_len=64,
                            int_lin=td.IntegerLinConfig(
                                policy="sorted_tiled_seq", acc_bits=16,
                                k_tile=16), device="cpu")
        tr = reqs(Request)
        eng.drain(tr)
        assert all(len(r.output) == 8 for r in tr)
        assert [r.output for r in tr] == [r.output for r in jr], storage


def test_batched_prefill_matches_stepwise(family):
    """One batched prefill of ragged prompts leaves each slot where its
    prompt fed through decode one token at a time does (the SSD's chunked
    state against the recurrence; MoE prefill routes a token a group, as
    decode does); the logits of 3 later decodes agree."""
    tmodel, tparams = family["tmodel"], family["tf"]
    vocab, lens = tmodel.cfg.vocab_size, (37, 6, 2)
    toks = np.zeros((3, 64), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = _tokens(vocab, (n,), 20 + b)
    nxt = torch.from_numpy(_tokens(vocab, (3, 3), 6))
    with torch.no_grad():
        caches = tmodel.init_caches(tparams, 3, 64, torch.float32)
        _, caches = tmodel.prefill(tparams, torch.from_numpy(toks), caches,
                                   torch.tensor(lens, dtype=torch.int32))
        batched = []
        for i in range(3):
            lg, caches = tmodel.decode(tparams, nxt[:, i : i + 1], caches)
            batched.append(lg)
        for b, n in enumerate(lens):
            c = tmodel.init_caches(tparams, 1, 64, torch.float32)
            for i in range(n):
                _, c = tmodel.decode(
                    tparams, torch.from_numpy(toks[b : b + 1, i : i + 1]), c)
            for i in range(3):
                lg, c = tmodel.decode(tparams, nxt[b : b + 1, i : i + 1], c)
                torch.testing.assert_close(lg[0], batched[i][b], rtol=0,
                                           atol=ATOL)


def test_engine_ssm_caches_keep_float32_state():
    """mamba2's engine caches: per layer {"ssd", "conv"}, no position; the
    SSD state stays float32 under a bfloat16 cache dtype through prefill
    and decode; an admission zeroes both of a slot's leaves."""
    cfg = _f32(get_config("mamba2-2.7b", smoke=True))
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init(0), num_slots=2, max_len=64,
                        cache_dtype=torch.bfloat16, device="cpu")
    dims = tssm.ssm_dims(cfg)
    for c in eng.caches:
        assert set(c) == {"ssd", "conv"}
        assert c["ssd"].dtype == torch.float32
        assert tuple(c["conv"].shape) == (2, 3, dims["d_xbc"])
    eng.submit(Request(uid=0, prompt=_tokens(256, (9,), 1),
                       max_new_tokens=3))
    eng.step()  # the prefill, then a decode
    assert all(c["ssd"].dtype == torch.float32 and c["ssd"][0].abs().sum()
               and c["conv"][0].abs().sum() for c in eng.caches)
    eng._reset(np.array([True, False]))
    assert not any(c["ssd"][0].any() or c["conv"][0].any()
                   for c in eng.caches)


def test_param_counts(family):
    tmodel = family["tmodel"]
    for jtree, ttree in ((family["jf"], family["tf"]),
                         (family["jq"], family["tq"]),
                         (family["jc"], family["tc"])):
        total = jmodel_lib.param_count(jtree)
        assert tmodel_lib.param_count(ttree) == total
        assert tmodel_lib.active_param_count(tmodel.cfg, total) == \
            jmodel_lib.active_param_count(family["jmodel"].cfg, total)
    for arch in ("granite-moe-3b-a800m", "granite-moe-1b-a400m"):
        assert tmodel_lib.active_param_count(get_config(arch), 10**10) == \
            jmodel_lib.active_param_count(jget_config(arch), 10**10)


# ---------------------------------------------------------------------------
# the compute-dtype cast of per-layer vectors
# ---------------------------------------------------------------------------


def _nonzero_vectors(tree, seed):
    """Every float leaf that is one vector a layer, drawn non-zero."""
    r = np.random.default_rng(seed)

    def conv(a):
        if a.ndim == 2 and jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                               * 0.3 + 1.0)
        return a

    return {**tree, "layers": jax.tree_util.tree_map(conv, tree["layers"]),
            "ln_f": jnp.asarray(r.standard_normal(tree["ln_f"].shape)
                                .astype(np.float32))}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b"])
def test_cast_for_compute_matches_jax_per_layer(arch):
    """In bfloat16 compute the JAX package's cast of the layer-stacked
    tree rounds every per-layer vector (norm gammas, biases, mamba2's
    a_log and dt_bias); the port's cast of its per-layer lists gives each
    leaf the dtype and value of its layer's slice; ``ln_f`` stays
    float32 in both."""
    jcfg = jget_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    assert jcfg.compute_dtype == tcfg.compute_dtype == "bfloat16"
    tree = _nonzero_vectors(jax.jit(jbuild_model(jcfg).init)(
        jax.random.PRNGKey(0)), 1)
    want = jmodel_lib.cast_for_compute(tree, jcfg)
    got = tmodel_lib.cast_for_compute(_port(tree), tcfg)
    n = 0
    for i, layer in enumerate(got["layers"]):
        jl = jax.tree_util.tree_map(lambda a: a[i], want["layers"])
        flat_t = {k: v for k, v in _flat(layer)}
        flat_j = {k: v for k, v in _flat(jl)}
        assert set(flat_t) == set(flat_j)
        for k, t in flat_t.items():
            j = flat_j[k]
            assert str(t.dtype).split(".")[-1] == str(j.dtype), (i, k)
            np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                          np.asarray(j, np.float32))
            n += t.ndim == 1
    assert n and got["ln_f"].dtype == torch.float32
    assert want["ln_f"].dtype == jnp.float32
    np.testing.assert_array_equal(got["ln_f"].numpy(),
                                  np.asarray(want["ln_f"]))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b"])
def test_engine_casts_params_once(arch):
    """The engine holds the compute-dtype tree (bfloat16 per-layer vectors,
    ``ln_f`` float32), so the model's cast on each step returns every
    tensor leaf as the same object: no step casts a leaf again."""
    jcfg = jget_config(arch, smoke=True)
    tcfg = get_config(arch, smoke=True)
    tree = _port(_nonzero_vectors(jax.jit(jbuild_model(jcfg).init)(
        jax.random.PRNGKey(0)), 1))
    eng = ServingEngine(build_model(tcfg, device="cpu"), tree, num_slots=2,
                        max_len=16, device="cpu")
    want = tmodel_lib.cast_for_compute(tree, tcfg)
    again = dict(_flat(tmodel_lib.cast_for_compute(eng.params, tcfg)))
    held = dict(_flat(eng.params))
    assert set(held) == set(again) == set(dict(_flat(want)))
    for k, w in _flat(want):
        assert held[k].dtype == w.dtype and again[k] is held[k], k
        assert torch.equal(held[k], w), k
    assert held[("ln_f",)].dtype == torch.float32
    assert eng.params["layers"] is not tree["layers"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# certification of expert stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["jq", "jc"])
def test_certificate_on_expert_stacks(storage):
    """On granite-moe smoke's dense (L, E, d, ff) and compressed (L, E, ff,
    G, n_keep) experts, the port's certificate equals the JAX package's
    field by field, and each verifies the other package's weights."""
    arch = "granite-moe-3b-a800m"
    jmodel = jbuild_model(_f32(jget_config(arch, smoke=True)))
    jtree = _quantize(jax.jit(jmodel.init)(jax.random.PRNGKey(2)))
    if storage == "jc":
        jtree = jqt.nm_compress_tree(jtree, 8, 16)
    ttree = _port(jtree)
    for acc_bits in (16, 24):
        jc = jcertify.certify_params(jtree, acc_bits, 8)
        tc = tcertify.certify_params(ttree, acc_bits, 8)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        certificate_from_fields(dataclasses.asdict(jc)).verify(ttree)
        jcertify.Certificate(
            sites=tuple(jcertify.SiteCertificate(**dataclasses.asdict(sc))
                        for sc in tc.sites), acc_bits=tc.acc_bits
        ).verify(jtree)
    assert {"w_gate", "w_up", "w_out", "wq"} <= {sc.site for sc in tc.sites}
