"""The port's dense decoder family against the JAX package: gemma3 (5:1
sliding-window rings, QK norm, scaled embeddings), qwen3 (QK norm, an
untied head) and command-r (layer norm), and soft-capping, the plain-GELU
MLP and query-chunked attention on the qwen2 smoke config.

Parameters come from the JAX init (float32 compute), quantized as
``tests/test_torch_serving.py`` quantizes them, and reach the port as
numpy arrays through ``repro_torch.convert.params_from_numpy``.

Tolerances, as in ``tests/test_torch_serving.py``: float logits agree to
atol 1e-4 (the same float32 operations summed in another order move the
last bits, about 1e-6 on these O(1) logits); integer sites are exact:
under ``integer_lin`` every site's int8 activation codes and its integer
dot equal the JAX package's (each ``pqs_dot`` call recorded in both
packages, the JAX one by an ordered ``jax.debug.callback`` inside its
layer scan), and the logits agree to the float atol; end to end the check
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
from repro.core import dispatch as jd
from repro.core import pruning as jpr
from repro.core import qtensor as jqt
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild_model
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch as td
from repro_torch.core import qtensor as tqt
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine

ATOL = 1e-4
ARCHS = ("gemma3-12b", "qwen3-32b", "command-r-35b")
# the qwen2 smoke config with one dense feature switched on
VARIANTS = {"softcap": dict(attn_logit_softcap=30.0),
            "gelu_plain": dict(activation="gelu_plain"),
            "chunked": dict(attn_chunk_threshold=16, attn_chunk_q=8)}


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _quantize(params):
    return jqt.quantize_tree(params, bits=8, n_keep=8, m=16,
                             min_size=1 << 12, min_dim=16)


def _pair(arch, **kw):
    """(JAX model, JAX quantized params, port model, port params)."""
    jmodel = jbuild_model(_f32(jget_config(arch, smoke=True), **kw))
    qparams = jax.jit(lambda: _quantize(jmodel.init(jax.random.PRNGKey(0))))()
    tmodel = build_model(_f32(get_config(arch, smoke=True), **kw),
                         device="cpu")
    return jmodel, qparams, tmodel, params_from_numpy(to_numpy(qparams),
                                                      device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return (request.param,) + _pair(request.param)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    return (request.param,) + _pair("qwen2-1.5b", **VARIANTS[request.param])


def _int_ctx(integer, jax_side):
    if not integer:
        return contextlib.nullcontext
    if jax_side:
        return lambda: jd.integer_lin(jd.IntegerLinConfig(
            policy="sorted_tiled_seq", acc_bits=16, k_tile=16,
            backend="jnp"))
    return lambda: td.integer_lin(td.IntegerLinConfig(
        policy="sorted_tiled_seq", acc_bits=16, k_tile=16))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("qwen2-1.5b",) + ARCHS)
def test_configs_copy_jax_and_validate(arch):
    """Full and smoke configs: every port field equals the JAX package's,
    and ``validate`` accepts them."""
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke), jget_config(arch, smoke)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        cfg.validate()


def _port_config(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{**fields, **kw})


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-medium",
                                  "qwen2-vl-72b"])
def test_validate_refuses_other_families(arch):
    """hybrid, encdec (whisper's family is audio) and vlm are ported, so
    ``validate`` accepts them; it refuses them where the JAX package's
    ``validate`` does: a hybrid without its ``moe``, an encoder-decoder
    without encoder layers, a family the zoo has not."""
    cfg = _port_config(jget_config(arch, smoke=True))
    cfg.validate()
    bad = {"jamba-v0.1-52b": dict(moe=None),
           "whisper-medium": dict(encoder_layers=0),
           "qwen2-vl-72b": dict(family="vision")}[arch]
    with pytest.raises(ValueError, match=next(iter(bad))):
        dataclasses.replace(cfg, **bad).validate()


@pytest.mark.parametrize("field,value", [
    ("is_encoder_decoder", True),
    ("mrope_sections", (2, 3, 1)),
    ("input_is_embeddings", True),
    ("moe_local_groups", True)])
def test_validate_refuses_features(field, value):
    """On a dense config each feature is refused where the JAX package's
    ``validate`` refuses it (an encoder-decoder with no encoder layers)
    and accepted where it accepts it (M-RoPE, embedding inputs), and
    ``moe_local_groups``, which needs a mesh, is refused by name."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               **{field: value})
    cfg = _port_config(jcfg)
    try:
        jcfg.validate()
        jax_refuses = False
    except AssertionError:
        jax_refuses = True
    if field == "moe_local_groups":
        assert not jax_refuses
        with pytest.raises(NotImplementedError, match=field):
            cfg.validate()
    elif jax_refuses:
        with pytest.raises(ValueError, match=field):
            cfg.validate()
    else:
        cfg.validate()
    assert jax_refuses == (field == "is_encoder_decoder")


def test_layer_windows_match_jax():
    for arch in ("qwen2-1.5b",) + ARCHS:
        for smoke in (False, True):
            assert ttransformer.layer_windows(get_config(arch, smoke)) == \
                jtransformer.layer_windows(jget_config(arch, smoke))
    wins = ttransformer.layer_windows(get_config("gemma3-12b"))
    assert wins[:6] == [1024] * 5 + [None] and len(wins) == 48


# ---------------------------------------------------------------------------
# conversion and quantization
# ---------------------------------------------------------------------------


def test_conversion_layout(family):
    arch, _, qparams, tmodel, tparams = family
    cfg = tmodel.cfg
    for i, layer in enumerate(tparams["layers"]):
        attn = layer["attn"]
        for key in ("q_norm", "k_norm"):
            assert (key in attn) == cfg.qk_norm
            if cfg.qk_norm:  # the (L, hd) stack: float, a row a layer
                assert isinstance(attn[key], torch.Tensor)
                assert attn[key].shape == (cfg.resolved_head_dim,)
                np.testing.assert_array_equal(
                    attn[key].numpy(),
                    np.asarray(qparams["layers"]["attn"][key][i]))
    assert ("head" in tparams) == (not cfg.tie_embeddings)
    assert isinstance(tparams["embed"], tqt.QTensor)
    if "head" in tparams:
        assert isinstance(tparams["head"], tqt.QTensor)
        np.testing.assert_array_equal(tparams["head"].values.numpy(),
                                      np.asarray(qparams["head"].values))
        np.testing.assert_array_equal(tparams["head"].scale.numpy(),
                                      np.asarray(qparams["head"].scale))


def test_port_quantize_tree_matches_jax():
    """The port's ``quantize_tree`` on qwen3's converted float params
    quantizes the leaves the JAX package does (the untied head and the
    embedding table) to the same codes; the QK-norm vectors stay float.
    (The JAX side eager: jitted, its codes may differ.)"""
    fparams = jax.jit(jbuild_model(_f32(jget_config(
        "qwen3-32b", smoke=True))).init)(jax.random.PRNGKey(0))
    kw = dict(bits=8, n_keep=8, m=16, min_size=1 << 12, min_dim=16)
    want = params_from_numpy(to_numpy(jqt.quantize_tree(fparams, **kw)),
                             device="cpu")
    got = tqt.quantize_tree(params_from_numpy(to_numpy(fparams),
                                              device="cpu"),
                            device="cpu", **kw)

    def walk(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], path + (k,))
        elif isinstance(b, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        elif isinstance(b, tqt.QTensor):
            assert isinstance(a, tqt.QTensor), path
            assert torch.equal(a.values, b.values), path
            assert torch.equal(a.scale, b.scale), path
        else:
            assert isinstance(a, torch.Tensor) and torch.equal(a, b), path

    walk(got, want, ())
    assert isinstance(got["embed"], tqt.QTensor)
    assert isinstance(got["head"], tqt.QTensor)
    assert isinstance(got["layers"][0]["attn"]["q_norm"], torch.Tensor)


# ---------------------------------------------------------------------------
# logits against the JAX package
# ---------------------------------------------------------------------------


def _forward_logits(jmodel, qparams, tmodel, tparams, toks):
    jl = np.asarray(jmodel.forward(qparams, {"tokens": jnp.asarray(toks)}))
    tl = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)}).numpy()
    return jl, tl


def test_forward_logits(family):
    """40 tokens: past gemma3's smoke window of 32."""
    _, jmodel, qparams, tmodel, tparams = family
    toks = _tokens(tmodel.cfg.vocab_size, (2, 40), 3)
    jl, tl = _forward_logits(jmodel, qparams, tmodel, tparams, toks)
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)


def _prefill_decode(model, params, toks, lengths, nxt, ctx, jax_side,
                    max_len=64, steps=3):
    """Logits of a batched prefill and of ``steps`` decodes after it (the
    next tokens teacher-forced from ``nxt``)."""
    cast = jnp.asarray if jax_side else torch.from_numpy
    dt = jnp.float32 if jax_side else torch.float32
    caches = model.init_caches(params, toks.shape[0], max_len, dt)
    out = []
    with ctx():
        # the float JAX side jitted; the integer one eager, as the JAX
        # package's tests run it (jitted, XLA turns the activation scale's
        # divide into a multiply by its reciprocal)
        prefill, decode = (
            (jax.jit(model.prefill), jax.jit(model.decode))
            if jax_side and ctx is contextlib.nullcontext
            else (model.prefill, model.decode))
        lp, caches = prefill(params, cast(toks), caches, cast(lengths))
        out.append(lp)
        for t in range(steps):
            ld, caches = decode(params, cast(nxt[:, t : t + 1]), caches)
            out.append(ld)
    return [np.asarray(o) if jax_side else o.numpy() for o in out]


@contextlib.contextmanager
def _sites(dispatch, jax_side):
    """Every ``pqs_dot`` call inside the context as (activation codes,
    integer dot) int64 arrays of shape (M, K) and (M, N), in call order."""
    calls, orig = [], dispatch.pqs_dot

    def keep(x, o):
        x, o = np.asarray(x, np.int64), np.asarray(o, np.int64)
        calls.append((x.reshape(-1, x.shape[-1]), o.reshape(-1, o.shape[-1])))

    def call(x, w, **kw):
        out = orig(x, w, **kw)
        if jax_side:  # traced inside the layer scan: keep the values it runs
            jax.debug.callback(keep, x, out, ordered=True)
        else:
            keep(x.numpy(), out.numpy())
        return out

    dispatch.pqs_dot = call
    try:
        yield calls
    finally:
        dispatch.pqs_dot = orig


def _check_prefill_decode(jmodel, qparams, tmodel, tparams, integer, s=40,
                          lengths=(40, 21, 0), max_len=64, steps=2):
    """The port's prefill-then-decode logits against JAX's; integer: every
    site's activation codes and integer dot equal too."""
    vocab = tmodel.cfg.vocab_size
    toks = _tokens(vocab, (len(lengths), s), 1)
    lengths = np.array(lengths, np.int32)
    nxt = _tokens(vocab, (len(lengths), steps), 2)
    sites = {}
    for side, (model, params, dispatch) in (
            ("jax", (jmodel, qparams, jd)), ("port", (tmodel, tparams, td))):
        jax_side = side == "jax"
        with (_sites(dispatch, jax_side) if integer
              else contextlib.nullcontext([])) as sites[side]:
            sites[side + " logits"] = _prefill_decode(
                model, params, toks, lengths, nxt,
                _int_ctx(integer, jax_side), jax_side, max_len, steps)
    for j, t in zip(sites["jax logits"], sites["port logits"]):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    # prefill and each decode: every quantized projection of every layer,
    # in order, and a quantized untied head
    per_pass = sum(tqt.is_qtensor(w) for layer in tparams["layers"]
                   for part in ("attn", "mlp")
                   for name, w in layer[part].items() if name.startswith("w"))
    per_pass += tqt.is_qtensor(tparams.get("head"))
    assert len(sites["port"]) == len(sites["jax"]) == (
        (1 + steps) * per_pass if integer else 0)
    for i, ((jx, jo), (tx, to)) in enumerate(zip(sites["jax"],
                                                 sites["port"])):
        np.testing.assert_array_equal(tx, jx, err_msg=f"codes, call {i}")
        np.testing.assert_array_equal(to, jo, err_msg=f"dot, call {i}")


@pytest.mark.parametrize("integer", [False, True])
def test_prefill_then_decode_logits(family, integer):
    """A 40-token prompt wraps gemma3's 32-slot rings at prefill; decode
    goes on past it. Integer: ``sorted_tiled_seq`` at k_tile 16 (qwen3's
    untied head an integer dot too)."""
    _, jmodel, qparams, tmodel, tparams = family
    _check_prefill_decode(jmodel, qparams, tmodel, tparams, integer)


def test_ring_shorter_than_window():
    """max_len 24 < gemma3's smoke window 32: the local layers' rings hold
    24 slots and wrap at 24; the global layer drops writes past 24."""
    jmodel, qparams, tmodel, tparams = _pair("gemma3-12b")
    caches = tmodel.init_caches(tparams, 2, 24, torch.float32)
    assert [c["k"].shape[1] for c in caches] == [24] * 6
    _check_prefill_decode(jmodel, qparams, tmodel, tparams, False, s=20,
                          lengths=(20, 13), max_len=24, steps=6)


def test_write_prefill_kv_ring_matches_jax():
    """A ring of 8 slots written from 20 prefill positions: each slot's
    last position survives (the port's ``write_prefill_kv`` unchanged)."""
    r = np.random.default_rng(5)
    k = r.standard_normal((4, 20, 2, 3)).astype(np.float32)
    v = r.standard_normal((4, 20, 2, 3)).astype(np.float32)
    cache = {"k": r.standard_normal((4, 8, 2, 3)).astype(np.float32),
             "v": r.standard_normal((4, 8, 2, 3)).astype(np.float32),
             "pos": np.zeros(4, np.int32)}
    lengths = np.array([20, 5, 0, 13], np.int32)
    jw = jlayers.write_prefill_kv({n: jnp.asarray(a) for n, a in
                                   cache.items()}, jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lengths))
    tw = tlayers.write_prefill_kv({n: torch.from_numpy(a) for n, a in
                                   cache.items()}, torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(lengths))
    for n in ("k", "v", "pos"):
        np.testing.assert_array_equal(tw[n].numpy(), np.asarray(jw[n]))


def test_cache_shapes_match_jax(family):
    _, jmodel, qparams, tmodel, tparams = family
    jc = jmodel.init_caches(qparams, 3, 48, jnp.float32)
    tc = tmodel.init_caches(tparams, 3, 48, torch.float32)
    if isinstance(jc, dict):  # stacked (L, ...) caches: one window
        jc = [{n: a[i] for n, a in jc.items()} for i in range(len(tc))]
    assert [tuple(c["k"].shape) for c in tc] == \
        [tuple(c["k"].shape) for c in jc]


# ---------------------------------------------------------------------------
# serving against the JAX engine
# ---------------------------------------------------------------------------

# a prompt past gemma3's smoke window (ring eviction at prefill), prompts
# whose decode passes it (the ring wraps), a 1-token prompt
PROMPT_LENS = (40, 6, 24, 11, 1)
MAX_NEW = 10


def _serve(engine_cls, request_cls, model, params, int_lin, **kw):
    eng = engine_cls(model, params, num_slots=3, max_len=64, int_lin=int_lin,
                     **kw)
    vocab = model.cfg.vocab_size
    reqs = [request_cls(uid=i, prompt=_tokens(vocab, (n,), 10 + i),
                        max_new_tokens=MAX_NEW)
            for i, n in enumerate(PROMPT_LENS)]
    eng.drain(reqs)
    return [r.output for r in reqs]


def test_engine_greedy_tokens(family):
    """5 requests on 3 slots under ``sorted_tiled_seq``: the JAX engine's
    greedy tokens."""
    _, jmodel, qparams, tmodel, tparams = family
    jt = _serve(JServingEngine, JRequest, jmodel, qparams, jd.IntegerLinConfig(
        policy="sorted_tiled_seq", acc_bits=16, k_tile=16, backend="jnp"))
    tt = _serve(ServingEngine, Request, tmodel, tparams, td.IntegerLinConfig(
        policy="sorted_tiled_seq", acc_bits=16, k_tile=16), device="cpu")
    assert all(len(o) == MAX_NEW for o in tt)
    assert tt == jt


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def test_forward_matches_stepwise_decode(family):
    """Teacher-forced forward logits equal step-by-step decode logits
    (``tests/test_models.py``'s check, here in float32), 40 steps: the
    rings wrap."""
    _, _, _, tmodel, tparams = family
    t = 40
    toks = torch.from_numpy(_tokens(tmodel.cfg.vocab_size, (1, t), 4))
    with torch.no_grad():
        full = tmodel.forward(tparams, {"tokens": toks})
        caches = tmodel.init_caches(tparams, 1, t, torch.float32)
        outs = []
        for i in range(t):
            lg, caches = tmodel.decode(tparams, toks[:, i : i + 1], caches)
            outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=0,
                               atol=ATOL)


def test_batched_prefill_matches_stepwise(family):
    """``tests/test_prefill_parity.py``'s contract: one batched prefill of
    ragged prompts (one past the window) leaves each slot where feeding
    its prompt through decode one token at a time does; the logits of 3
    later decodes agree."""
    _, _, _, tmodel, tparams = family
    vocab, lens = tmodel.cfg.vocab_size, (37, 6, 19)
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


# ---------------------------------------------------------------------------
# soft-capping, the plain-GELU MLP and query-chunked attention (qwen2 smoke)
# ---------------------------------------------------------------------------


def test_variant_forward_logits(variant):
    """32 tokens (the chunked variant: 4 query chunks of 8)."""
    _, jmodel, qparams, tmodel, tparams = variant
    toks = _tokens(tmodel.cfg.vocab_size, (2, 32), 7)
    jl, tl = _forward_logits(jmodel, qparams, tmodel, tparams, toks)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)


@pytest.mark.parametrize("integer", [False, True])
def test_variant_prefill_then_decode_logits(variant, integer):
    """A 32-token prefill (chunked: at the lowered threshold of 16)."""
    _, jmodel, qparams, tmodel, tparams = variant
    _check_prefill_decode(jmodel, qparams, tmodel, tparams, integer, s=32,
                          lengths=(32, 9, 0))


def test_chunked_attention_matches_unchunked():
    """The chunked path gives the unchunked path's logits in the port, and
    runs every layer's attention in query chunks of 8."""
    _, _, tmodel, tparams = _pair("qwen2-1.5b", **VARIANTS["chunked"])
    plain = build_model(_f32(get_config("qwen2-1.5b", smoke=True)),
                        device="cpu")
    toks = torch.from_numpy(_tokens(256, (2, 32), 8))
    calls = []
    orig = tlayers._sdpa_chunked

    def spy(*a, **kw):
        calls.append(a[-1])  # the chunk
        return orig(*a, **kw)

    with torch.no_grad():
        tlayers._sdpa_chunked = spy
        try:
            chunked = tmodel.forward(tparams, {"tokens": toks})
        finally:
            tlayers._sdpa_chunked = orig
        whole = plain.forward(tparams, {"tokens": toks})
    assert calls == [8] * tmodel.cfg.num_layers
    torch.testing.assert_close(chunked, whole, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# scaled embeddings in bfloat16 at gemma3's width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_scaled_embeddings_bf16(quantized):
    """d_model 3840: sqrt(3840) = 61.97 rounds to 62.0 in bfloat16 before
    the multiply, as in the JAX package; the port's embeddings equal
    JAX's bit for bit, and differ from a multiply by the float32 factor."""
    cfg = dataclasses.replace(get_config("gemma3-12b"), vocab_size=64)
    jcfg = dataclasses.replace(jget_config("gemma3-12b"), vocab_size=64)
    table = np.random.default_rng(9).standard_normal(
        (64, 3840)).astype(np.float32) / 62.0
    jemb = jnp.asarray(table)
    if quantized:
        jemb = jqt.quantize_weight(jemb, 8, None, 16)
    temb = params_from_numpy(to_numpy({"embed": jemb}), device="cpu")
    toks = _tokens(64, (2, 9), 10)
    j = jtransformer.embed_tokens({"embed": jemb}, jnp.asarray(toks), jcfg)
    t = ttransformer.embed_tokens(temb, torch.from_numpy(toks), cfg)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    unscaled = ttransformer.embed_tokens(
        temb, torch.from_numpy(toks),
        dataclasses.replace(cfg, scale_embeddings=False))
    assert not torch.equal(t, (unscaled.float() * 3840**0.5).to(
        torch.bfloat16))


# ---------------------------------------------------------------------------
# the census chunked over N
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["dense", "nm"])
def test_census_chunks_n(monkeypatch, storage):
    """A budget under one row's product cube chunks N as well as M: the
    counts equal the unchunked census's and the JAX package's."""
    r = np.random.default_rng(11)
    x = r.integers(-128, 128, (3, 96)).astype(np.int8)
    x[0] = 127
    w = r.integers(-127, 128, (40, 96))
    kw = dict(policy="sorted_tiled_seq", acc_bits=12, k_tile=16,
              with_census=True)
    if storage == "dense":
        wd = w.astype(np.int8)
        jw, tw, nm = jnp.asarray(wd), torch.from_numpy(wd), {}
    else:
        mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(w, jnp.float32), 8,
                                            16))
        wd = (w * mask).astype(np.int8)
        vals, idx = (np.ascontiguousarray(a)
                     for a in jpr.nm_compress(wd, 8, 16))
        scale = np.ones(40, np.float32)
        jw = jqt.SparseQTensor(jnp.asarray(vals), jnp.asarray(idx),
                               jnp.asarray(scale), 16, 96)
        tw = tqt.SparseQTensor(torch.from_numpy(vals), torch.from_numpy(idx),
                               torch.from_numpy(scale), 16, 96)
        nm = dict(storage="nm")
    fields = ("n_dots", "n_persistent", "n_transient", "n_any", "n_combine")
    _, jc = jd.pqs_dot(jnp.asarray(x), jw, backend="jnp", **nm, **kw)
    out, whole = td.pqs_dot(torch.from_numpy(x), tw, **nm, **kw)
    # 7 outputs a chunk: a row's cube is 40 x 96 (dense) or 40 x 48 int32
    width = 96 if storage == "dense" else 48
    monkeypatch.setattr(td, "_CENSUS_BUDGET", 4 * width * 7)
    chunks = []
    orig = td.census
    monkeypatch.setattr(td, "census", lambda p, b: chunks.append(p.shape)
                        or orig(p, b))
    out1, chunked = td.pqs_dot(torch.from_numpy(x), tw, **nm, **kw)
    assert chunks == ([(1, 7, width)] * 5 + [(1, 5, width)]) * 3
    assert torch.equal(out, out1)
    want = [int(getattr(jc, f)) for f in fields]
    assert [int(getattr(whole, f)) for f in fields] == want
    assert [int(getattr(chunked, f)) for f in fields] == want
    assert want[0] == 120 and want[3] > 0
