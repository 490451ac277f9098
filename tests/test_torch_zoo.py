"""The rest of the model zoo in the port against the JAX package: the
hybrid (jamba: Mamba2 / attention / MoE interleave), the encoder-decoder
(whisper) and the vlm backbone (qwen2-vl: M-RoPE, embedding inputs), and
the stacking rule of the tree functions.

Parameters come from the JAX init (float32 compute unless a test says
bfloat16, ``remat=False`` so that an eager JAX forward records each site
once), quantized as ``tests/test_torch_moe_ssm.py`` quantizes them (8:16
int8, ``min_size`` 4096, ``min_dim`` 16), and reach the port as numpy
arrays through ``repro_torch.convert.params_from_numpy``. The JAX side of
a quantized jamba comparison serves the compressed tree: the JAX
package's dense ``QTensor.dequant`` cannot broadcast an expert stack's
scale (``tests/test_torch_moe_ssm.py`` says more); the port serves both
of its storages.

Tolerances: float32 logits and states agree to atol 1e-4 (``ATOL``, as
the earlier family files state it: the same float32 operations summed in
another order move the last bits). Integer sites are held bit for bit
against the JAX package's, call by call (``_held_sites``): every
``pqs_dot`` call's activation codes and integer dot are recorded in the
JAX package (by an ordered ``jax.debug.callback``), and the port's call
in the same place must give the same codes, save a code at a rounding
boundary that the float order moved by one (at most ``FLIP_SHARE`` of a
call's codes, by at most 1: XLA and torch sum the float paths between
sites, the experts' einsums, the SSD and the attention, in different
orders, and the JAX side runs jitted, where XLA multiplies by the
activation scale's reciprocal instead of dividing by it), and must give
JAX's integer dot, bit for bit, on JAX's codes,
which it then serves, so that a flip does not travel down the model and
the logits agree to ``ATOL``. End to end the check is identical greedy
tokens.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_to_port import to_numpy

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import dispatch as jd
from repro.core import qtensor as jqt
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model as jmodel_lib
from repro.models.model import build_model as jbuild_model
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch as td
from repro_torch.core import qtensor as tqt
from repro_torch.core.tree import LayerStack, tree_map
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel_lib
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine

ATOL = 1e-4
ARCHS = ("jamba-v0.1-52b", "whisper-medium", "qwen2-vl-72b")
QKW = dict(bits=8, n_keep=8, m=16, min_size=1 << 12, min_dim=16)
FLIP_SHARE = 1e-3  # codes of a call a float order may move by one


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _port(tree):
    return params_from_numpy(to_numpy(tree), device="cpu")


def _rng_ints(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(arch, JAX model, JAX float / quantized / compressed params, port
    model, the port's three trees converted from them)."""
    arch = request.param
    jmodel = jbuild_model(_f32(jget_config(arch, smoke=True), remat=False))
    fparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    # eager: jitted, XLA divides by qmax as a multiply by its reciprocal,
    # and the codes may differ from the port's quantize_tree
    qparams = jqt.quantize_tree(fparams, **QKW)
    cparams = jqt.nm_compress_tree(qparams, 8, 16)
    tmodel = build_model(_f32(get_config(arch, smoke=True)), device="cpu")
    return dict(arch=arch, jmodel=jmodel, jf=fparams, jq=qparams,
                jc=cparams, tmodel=tmodel, tf=_port(fparams),
                tq=_port(qparams), tc=_port(cparams))


def _quantize_jit(params):
    """The JAX package's quantized tree, jitted, where both packages then
    serve that one tree (``test_quantize_and_compress_match_jax`` holds
    the port's own ``quantize_tree`` against the eager one)."""
    return jax.jit(lambda p: jqt.quantize_tree(p, **QKW))(params)


def _jax_int_tree(fam):
    """The JAX tree a quantized comparison serves: compressed for jamba
    (its dense experts do not dequantize), dense otherwise."""
    return fam["jc"] if fam["tmodel"].cfg.moe is not None else fam["jq"]


def _int_ctx(jax_side):
    if jax_side:
        return jd.integer_lin(jd.IntegerLinConfig(
            policy="sorted_tiled_seq", acc_bits=16, k_tile=16,
            backend="jnp"))
    return td.integer_lin(td.IntegerLinConfig(
        policy="sorted_tiled_seq", acc_bits=16, k_tile=16))


@contextlib.contextmanager
def _jax_sites():
    """Every JAX ``pqs_dot`` call inside the context as (activation codes,
    integer dot) int64 arrays (M, K) and (M, N), in call order."""
    calls, orig = [], jd.pqs_dot

    def keep(x, o):
        x, o = np.asarray(x, np.int64), np.asarray(o, np.int64)
        calls.append((x.reshape(-1, x.shape[-1]), o.reshape(-1, o.shape[-1])))

    def call(x, w, **kw):
        out = orig(x, w, **kw)
        jax.debug.callback(keep, x, out, ordered=True)
        return out

    jd.pqs_dot = call
    try:
        yield calls
    finally:
        jd.pqs_dot = orig


@contextlib.contextmanager
def _held_sites(want, n):
    """The port's ``pqs_dot`` calls inside the context held against the
    JAX calls ``want`` in order (module docstring): the same codes save
    rounding flips, JAX's dot on JAX's codes, which the port then serves.
    On exit there must have been ``n`` calls on each side. Yields the
    record: calls made and codes flipped."""
    rec, orig = {"calls": 0, "flips": 0}, td.pqs_dot

    def call(x, w, **kw):
        i = rec["calls"]
        rec["calls"] += 1
        jx, jo = want[i]
        d = np.abs(x.numpy().astype(np.int64).reshape(jx.shape) - jx)
        flips = int((d > 0).sum())
        assert d.max(initial=0) <= 1 and flips <= FLIP_SHARE * d.size, (
            f"call {i}: codes differ at {flips} of {d.size}, by up to "
            f"{d.max()}")
        rec["flips"] += flips
        out = orig(torch.from_numpy(jx).to(x.dtype).reshape(x.shape), w,
                   **kw)
        np.testing.assert_array_equal(
            out.numpy().astype(np.int64).reshape(jo.shape), jo,
            err_msg=f"dot, call {i}")
        return out

    td.pqs_dot = call
    try:
        yield rec
    finally:
        td.pqs_dot = orig
    assert n and rec["calls"] == len(want) == n, (rec["calls"], len(want),
                                                  n)


def _quantized_sites(layers, parts):
    """Quantized projections a pass makes in ``layers`` (those of
    ``parts`` whose name starts with w or ends in _proj)."""
    return sum(tqt.is_qtensor(w) for layer in layers for part in parts
               if part in layer for name, w in layer[part].items()
               if name.startswith("w") or name.endswith("_proj"))


# ---------------------------------------------------------------------------
# configs and the registry
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


def test_registry_lists_every_jax_arch():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_runs_on_cuda_unless_asked(arch, monkeypatch):
    """Without a card and without ``device="cpu"`` the model refuses to
    build (no fallback to the CPU); asked for the CPU it builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for smoke in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_config(arch, smoke))
    assert build_model(get_config(arch, True), device="cpu").device == \
        torch.device("cpu")


# ---------------------------------------------------------------------------
# the stacking rule: quantize, compress, cast
# ---------------------------------------------------------------------------


def _walk_equal(got, want, path=()):
    """Port trees leaf for leaf: the same node types (a ``LayerStack``
    where the other has one), QTensor / SparseQTensor arrays and float
    tensors equal, dtypes included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _walk_equal(got[k], want[k], path + (k,))
    elif isinstance(want, list):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _walk_equal(a, b, path + (i,))
    elif tqt.is_qtensor(want):
        assert type(got) is type(want), path
        for f in ("values", "scale") + (
                ("indices",) if isinstance(want, tqt.SparseQTensor) else ()):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and torch.equal(a, b), (path, f)
    else:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == want.dtype and torch.equal(got, want), path


def test_conversion_marks_the_stacks(family):
    """The JAX package's stacked layers become ``LayerStack``s; jamba's
    list of layers stays a plain list (and its layers keep their kinds:
    attention at layer 4, MoE on the odd layers)."""
    tf, cfg = family["tf"], family["tmodel"].cfg
    if cfg.family == "hybrid":
        layers = tf["layers"]
        assert type(layers) is list and len(layers) == cfg.num_layers
        assert [("attn" in p, "moe" in p) for p in layers] == [
            (i % 8 == 4, i % 2 == 1) for i in range(cfg.num_layers)]
    elif cfg.is_encoder_decoder:
        assert type(tf["enc_layers"]) is LayerStack
        assert type(tf["dec_layers"]) is LayerStack
        assert len(tf["enc_layers"]) == cfg.encoder_layers
    else:
        assert type(tf["layers"]) is LayerStack
        assert "embed" not in tf and "head" in tf  # embeddings in, untied
    init = family["tmodel"].init(0)
    assert {k: type(v) for k, v in init.items()} == {
        k: type(v) for k, v in tf.items()}


def test_quantize_and_compress_match_jax(family):
    """The port's ``quantize_tree`` and ``nm_compress_tree`` on the
    converted float tree give the JAX package's leaves, codes and dtypes."""
    got = tqt.quantize_tree(family["tf"], device="cpu", **QKW)
    _walk_equal(got, family["tq"])
    _walk_equal(tqt.nm_compress_tree(got, 8, 16), family["tc"])


def test_hybrid_quantize_takes_leaves_one_by_one():
    """At ``min_size`` 16384 the JAX package quantizes each leaf of
    jamba's list of layers on its own: in_proj (64 x 280), the experts (4
    x 64 x 128) and the table, and not the attention, the MLPs or
    out_proj (8192 elements). Counting the 8 layers as a stack (what a
    ``LayerStack`` asks for) would quantize those too."""
    cfg = _f32(jget_config("jamba-v0.1-52b", smoke=True))
    fparams = jax.jit(jbuild_model(cfg).init)(jax.random.PRNGKey(1))
    kw = dict(QKW, min_size=1 << 14)
    want = _port(jqt.quantize_tree(fparams, **kw))
    got = tqt.quantize_tree(_port(fparams), device="cpu", **kw)
    _walk_equal(got, want)
    _walk_equal(tqt.nm_compress_tree(got, 8, 16),
                _port(jqt.nm_compress_tree(jqt.quantize_tree(fparams, **kw),
                                           8, 16)))
    for layer in got["layers"]:
        mixer = layer.get("mamba", layer.get("attn"))
        if "mamba" in layer:
            assert isinstance(mixer["in_proj"], tqt.QTensor)
            assert isinstance(mixer["out_proj"], torch.Tensor)
        else:
            assert all(isinstance(mixer[k], torch.Tensor)
                       for k in ("wq", "wk", "wv", "wo"))
        ffn = layer.get("moe", layer.get("mlp"))
        assert isinstance(ffn["w_gate"], tqt.QTensor) == ("moe" in layer)
    stacked = tqt.quantize_tree({**_port(fparams), "layers": LayerStack(
        _port(fparams)["layers"])}, device="cpu", **kw)
    assert isinstance(stacked["layers"][1]["mamba"]["out_proj"],
                      tqt.QTensor)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def _nonzero_vectors(tree, seed):
    """Every float per-layer vector drawn non-zero, so that a cast which
    rounds it shows: (L, d) leaves of a stacked dict, (d,) leaves
    elsewhere (the hybrid's list, ``ln_f``)."""
    r = np.random.default_rng(seed)

    def draw(a, ndim):
        if a.ndim != ndim or not jnp.issubdtype(a.dtype, jnp.floating):
            return a
        return jnp.asarray(r.standard_normal(a.shape).astype(np.float32)
                           * 0.3 + 1.0)

    return {k: jax.tree_util.tree_map(
        lambda a, nd=2 if isinstance(v, dict) and k.endswith("layers")
        else 1: draw(a, nd), v) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_for_compute_matches_jax(arch):
    """In bfloat16 compute: the JAX package casts its stacked trees, where
    a per-layer vector is an (L, d) matrix, and its hybrid list leaf by
    leaf, where it stays a float32 vector (jamba's norms, ``a_log``,
    ``dt_bias``); the port's cast gives every leaf the dtype and value
    of the JAX leaf (a stacked one's row)."""
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    assert jcfg.compute_dtype == tcfg.compute_dtype == "bfloat16"
    tree = _nonzero_vectors(jax.jit(jbuild_model(jcfg).init)(
        jax.random.PRNGKey(0)), 1)
    want = jmodel_lib.cast_for_compute(tree, jcfg)
    got = tmodel_lib.cast_for_compute(_port(tree), tcfg)
    stacks = [k for k, v in got.items() if isinstance(v, LayerStack)]
    flat_j = {}
    for k, v in want.items():
        if k in stacks:
            for i in range(len(got[k])):
                flat_j.update(_flat(jax.tree_util.tree_map(
                    lambda a: a[i], v), (k, i)))
        else:
            flat_j.update(_flat(v, (k,)))
    flat_t = dict(_flat(got))
    assert set(flat_t) == set(flat_j)
    vectors = {"float32": 0, "bfloat16": 0}
    for k, t in flat_t.items():
        j = flat_j[k]
        assert str(t.dtype).split(".")[-1] == str(j.dtype), k
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(j, np.float32))
        if t.ndim == 1:
            vectors[str(t.dtype).split(".")[-1]] += 1
    # jamba's layer vectors stay float32, the stacks' are rounded
    assert vectors["float32"] and (arch == "jamba-v0.1-52b") == (
        not vectors["bfloat16"])


# ---------------------------------------------------------------------------
# M-RoPE and the encoder
# ---------------------------------------------------------------------------


def test_apply_rope_mrope_streams():
    """(3, B, S) positions whose t / h / w streams differ, sections (2, 3,
    3) of head_dim 16 and (16, 24, 24) of 128: each frequency slot rotated
    by its own stream, as in the JAX package; equal streams give plain
    RoPE."""
    for hd, sections, theta in ((16, (2, 3, 3), 1e6),
                                (128, (16, 24, 24), 1e6)):
        x = _normal((2, 12, 3, hd), 5)
        pos = np.random.default_rng(6).integers(0, 64, (3, 2, 12)).astype(
            np.int32)
        j = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), hd, theta,
                               sections)
        t = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               hd, theta, sections)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5)
        same = torch.from_numpy(np.broadcast_to(pos[0], (3, 2, 12)).copy())
        torch.testing.assert_close(
            tlayers.apply_rope(torch.from_numpy(x), same, hd, theta,
                               sections),
            tlayers.apply_rope(torch.from_numpy(x), same[0], hd, theta),
            rtol=0, atol=0)


def test_sinusoids():
    """Whisper's 1500-frame window: torch's and XLA's float32 ``exp`` may
    differ in the last bit of a frequency, which position p multiplies
    into the angle, so the tolerance grows with the length: 1500 x 2^-22
    (the JAX package's own values sit as far from a float64 evaluation of
    the formula)."""
    n, c = 1500, 64
    t = tencdec.sinusoids(n, c).numpy()
    j = np.asarray(jencdec.sinusoids(n, c))
    inv = np.exp(-np.log(10000.0) / (c // 2 - 1) * np.arange(c // 2))
    ang = np.arange(n)[:, None] * inv[None]
    ref = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    for got in (t, j):
        np.testing.assert_allclose(got, ref, rtol=0, atol=n * 2.0**-22)
    np.testing.assert_allclose(t, j, rtol=0, atol=n * 2.0**-22)
    assert t.shape == (n, c) and t.dtype == np.float32


def _frames(b, s, d, seed):
    return _normal((b, s, d), seed)


@pytest.mark.parametrize("integer", [False, True])
def test_encode(integer):
    """whisper's encoder over 2 clips of 48 frames: the states within
    ``ATOL``, float and integer (dense storage, every site held)."""
    jcfg = _f32(jget_config("whisper-medium", smoke=True), remat=False)
    cfg = _f32(get_config("whisper-medium", smoke=True))
    fparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(2))
    jp = _quantize_jit(fparams) if integer else fparams
    tp = _port(jp)
    frames = _frames(2, 48, cfg.d_model, 7)
    n = _quantized_sites(tp["enc_layers"], ("attn", "mlp"))
    with _jax_sites() if integer else contextlib.nullcontext([]) as js:
        with _int_ctx(True) if integer else contextlib.nullcontext():
            j = np.asarray(jax.jit(lambda p, f: jencdec.encode(p, f, jcfg))(
                jp, jnp.asarray(frames)))
    with _held_sites(js, n) if integer else contextlib.nullcontext():
        with _int_ctx(False) if integer else contextlib.nullcontext():
            t = tencdec.encode(tp, torch.from_numpy(frames), cfg).numpy()
    assert t.shape == (2, 48, cfg.d_model) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# forward, prefill + decode and the engine against the JAX package
# ---------------------------------------------------------------------------


def _vlm_positions(b):
    """64 image patches on an 8 x 8 grid (t 0, h the row, w the column),
    then 32 text positions, all three streams at 8 + i."""
    grid = np.arange(64)
    img = np.stack([np.zeros(64), grid // 8, grid % 8])
    text = np.broadcast_to(8 + np.arange(32), (3, 32))
    pos = np.concatenate([img, text], axis=1).astype(np.int32)
    return np.broadcast_to(pos[:, None], (3, b, 96)).copy()


def _forward_batch(fam, seed):
    """The numpy batch of a forward: tokens, frames and tokens, or
    embeddings with distinct M-RoPE streams."""
    cfg = fam["tmodel"].cfg
    if cfg.family == "vlm":
        return {"embeddings": _normal((2, 96, cfg.d_model), seed),
                "positions": _vlm_positions(2)}
    toks = _rng_ints(cfg.vocab_size, (2, 32), seed)
    if cfg.is_encoder_decoder:
        return {"frames": _frames(2, 40, cfg.d_model, seed), "tokens": toks}
    return {"tokens": toks}


def _forward_sites(tree):
    """Quantized projections of one forward: every layer's, whisper's
    encoder and its decoder's cross-attention (K / V from the encoder
    states) included, and an untied head."""
    n = tqt.is_qtensor(tree.get("head"))
    for key in ("layers", "enc_layers", "dec_layers"):
        n += _quantized_sites(tree.get(key, []),
                              ("attn", "xattn", "mamba", "mlp"))
    return n


@pytest.mark.parametrize("integer", [False, True])
def test_forward_logits(family, integer):
    """Float: logits within ``ATOL`` (and jamba's MoE aux loss within
    1e-6). Integer, ``sorted_tiled_seq`` at k_tile 16 from each of the
    port's storages: every site held, the JAX logits within ``ATOL``
    (qwen2-vl's embeddings at distinct M-RoPE streams)."""
    jmodel, tmodel = family["jmodel"], family["tmodel"]
    batch = _forward_batch(family, 3)
    jtree = _jax_int_tree(family) if integer else family["jf"]
    with _jax_sites() if integer else contextlib.nullcontext([]) as js:
        with _int_ctx(True) if integer else contextlib.nullcontext():
            jl = np.asarray(jax.jit(jmodel.forward)(jtree, {
                k: jnp.asarray(v) for k, v in batch.items()}))
    for storage in (("tq", "tc") if integer else ("tf",)):
        tree = family[storage]
        with _held_sites(js, _forward_sites(tree)) if integer else \
                contextlib.nullcontext(), \
                _int_ctx(False) if integer else contextlib.nullcontext():
            tl = tmodel.forward(tree, {
                k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
        assert tl.shape == jl.shape and np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL,
                                   err_msg=storage)
    if tmodel.cfg.family == "hybrid" and not integer:
        from repro.models import hybrid as jhybrid
        from repro_torch.models import hybrid as thybrid

        _, ja = jhybrid.forward(family["jf"], jnp.asarray(batch["tokens"]),
                                None, jmodel.cfg)
        _, ta = thybrid.forward(family["tf"], torch.from_numpy(
            batch["tokens"]), None, tmodel.cfg)
        assert float(ta) > 0 and abs(float(ta) - float(ja)) <= 1e-6


def _caches(model, params, fam, jax_side, b, enc):
    """Decode caches of 64 slots a layer; the encoder-decoder's cross K/V
    from ``enc`` (numpy encoder states), built outside any integer
    context, as the engine builds them."""
    dt = jnp.float32 if jax_side else torch.float32
    kw = {}
    if fam["tmodel"].cfg.is_encoder_decoder:
        kw["enc_out"] = jnp.asarray(enc) if jax_side else torch.from_numpy(
            enc)
    return model.init_caches(params, b, 64, dt, **kw)


def _prefill_inputs(fam):
    """(prompts, lengths, next inputs of 2 decodes): tokens, or for the
    vlm embeddings."""
    cfg = fam["tmodel"].cfg
    lengths = np.array([40, 21, 2, 0], np.int32)
    if cfg.family == "vlm":
        return (_normal((4, 64, cfg.d_model), 1), lengths,
                _normal((4, 2, cfg.d_model), 2))
    return (_rng_ints(cfg.vocab_size, (4, 64), 1), lengths,
            _rng_ints(cfg.vocab_size, (4, 2), 2))


def _run_prefill_decode(model, params, fam, jax_side, integer, enc):
    cast = jnp.asarray if jax_side else torch.from_numpy
    toks, lengths, nxt = _prefill_inputs(fam)
    caches = _caches(model, params, fam, jax_side, 4, enc)
    out = []
    ctx = _int_ctx(jax_side) if integer else contextlib.nullcontext()
    prefill, decode = ((jax.jit(model.prefill), jax.jit(model.decode))
                       if jax_side else (model.prefill, model.decode))
    with ctx:
        lp, caches = prefill(params, cast(toks), caches, cast(lengths))
        out.append(lp)
        for t in range(nxt.shape[1]):
            ld, caches = decode(params, cast(nxt[:, t : t + 1]), caches)
            out.append(ld)
    return [np.asarray(o) if jax_side else o.numpy() for o in out]


@pytest.mark.parametrize("integer", [False, True])
def test_prefill_then_decode(family, integer):
    """A batched prefill of 64-token lanes (40, 21, 2 and 0 tokens; jamba's
    two SSD chunks of 32), then 2 decodes; whisper's cross K/V from 48
    encoded frames. Integer: ``sorted_tiled_seq`` at k_tile 16 from both
    of the port's storages, every site held (qwen2-vl's untied head
    included)."""
    jmodel, tmodel = family["jmodel"], family["tmodel"]
    cfg = tmodel.cfg
    jparams = _jax_int_tree(family) if integer else family["jf"]
    tparams = family["tq"] if integer else family["tf"]
    enc = None
    if cfg.is_encoder_decoder:
        enc = np.asarray(jencdec.encode(family["jf"], jnp.asarray(
            _frames(4, 48, cfg.d_model, 9)), jmodel.cfg))
    if cfg.is_encoder_decoder:
        per_pass = _quantized_sites(tparams["dec_layers"], ("attn", "mlp"))
        # the cross-attention's wq and wo a layer (its K/V are cached)
        per_pass += sum(tqt.is_qtensor(p["xattn"][k])
                        for p in tparams["dec_layers"] for k in ("wq", "wo"))
    else:
        per_pass = _quantized_sites(tparams["layers"],
                                    ("attn", "mamba", "mlp"))
        per_pass += tqt.is_qtensor(tparams.get("head"))
    with _jax_sites() if integer else contextlib.nullcontext([]) as js:
        jl = _run_prefill_decode(jmodel, jparams, family, True, integer, enc)
    for storage in (("tq", "tc") if integer else ("tf",)):
        with _held_sites(js, 3 * per_pass) if integer else \
                contextlib.nullcontext():
            tl = _run_prefill_decode(tmodel, family[storage], family, False,
                                     integer, enc)
        for j, t in zip(jl, tl):
            assert t.shape == j.shape and np.isfinite(t).all()
            np.testing.assert_allclose(t, j, rtol=0, atol=ATOL,
                                       err_msg=storage)


@pytest.mark.parametrize("storage", ["tq", "tc"])
def test_precompute_cross_kv_integer(storage):
    """whisper's cross K/V inside ``integer_lin``: their unnamed projections
    run as integer dots, each held against the JAX package's (recorded a
    layer at a time: its vmapped call takes no ordered callback), and the
    K/V within ``ATOL`` of the JAX package's."""
    jcfg = _f32(jget_config("whisper-medium", smoke=True), remat=False)
    cfg = _f32(get_config("whisper-medium", smoke=True))
    fparams = jax.jit(jbuild_model(jcfg).init)(jax.random.PRNGKey(3))
    jq = _quantize_jit(fparams)
    tree = _port(jq) if storage == "tq" else _port(
        jqt.nm_compress_tree(jq, 8, 16))
    enc = _normal((2, 30, cfg.d_model), 4)
    with _int_ctx(True):
        want = jencdec.precompute_cross_kv(jq, jnp.asarray(enc), jcfg)
    with _jax_sites() as js, _int_ctx(True):
        for i in range(cfg.num_layers):  # the layers' calls, unvmapped
            layer = jax.tree_util.tree_map(lambda a: a[i], jq["dec_layers"])
            jencdec.precompute_cross_kv({"dec_layers": jax.tree_util.tree_map(
                lambda a: a[None], layer)}, jnp.asarray(enc), jcfg)
    with _int_ctx(False), _held_sites(js, 2 * cfg.num_layers):
        got = tencdec.precompute_cross_kv(tree, torch.from_numpy(enc), cfg)
    for i, layer in enumerate(got):
        for k in ("k", "v"):
            np.testing.assert_allclose(layer[k].numpy(),
                                       np.asarray(want[k][i]), rtol=0,
                                       atol=ATOL)


def test_vlm_decode_embeddings_at_mrope_positions():
    """qwen2-vl decodes (B, 1, d) embeddings; under M-RoPE the three
    streams take the cache position, so a decode equals a forward whose
    streams are all the token index (the prompt's last position)."""
    cfg = _f32(get_config("qwen2-vl-72b", smoke=True))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    emb = torch.from_numpy(_normal((2, 9, cfg.d_model), 8))
    with torch.no_grad():
        full = model.forward(params, {"embeddings": emb})
        caches = model.init_caches(params, 2, 16, torch.float32)
        _, caches = model.prefill(params, emb[:, :8], caches,
                                  torch.tensor([8, 8], dtype=torch.int32))
        last, _ = model.decode(params, emb[:, 8:], caches)
    torch.testing.assert_close(last[:, 0], full[:, 8], rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-medium"])
def test_engine_greedy_tokens(arch):
    """5 requests on 3 slots, admitted in 3 cohorts, under
    ``sorted_tiled_seq`` (float32 compute,
    as ``tests/test_prefill_parity.py`` sets it): the JAX engine's greedy
    tokens, from both of the port's storages. whisper's engine builds its
    cross K/V from a zero encoder output, as the JAX engine does."""
    jmodel = jbuild_model(_f32(jget_config(arch, smoke=True)))
    tmodel = build_model(_f32(get_config(arch, smoke=True)), device="cpu")
    fparams = jax.jit(jmodel.init)(jax.random.PRNGKey(4))
    jq = _quantize_jit(fparams)
    jc = jqt.nm_compress_tree(jq, 8, 16)
    vocab = tmodel.cfg.vocab_size

    def reqs(cls):  # every cohort's prefill in the 16-token bucket
        return [cls(uid=i, prompt=_rng_ints(vocab, (n,), 10 + i),
                    max_new_tokens=m)
                for i, (n, m) in enumerate(((17, 6), (10, 4), (12, 6),
                                            (16, 5), (11, 3)))]

    jeng = JServingEngine(jmodel, jc if tmodel.cfg.moe else jq, num_slots=3,
                          max_len=64, int_lin=jd.IntegerLinConfig(
                              policy="sorted_tiled_seq", acc_bits=16,
                              k_tile=16, backend="jnp"))
    jr = reqs(JRequest)
    jeng.drain(jr)
    for tree in (jq, jc):
        eng = ServingEngine(tmodel, _port(tree), num_slots=3, max_len=64,
                            int_lin=td.IntegerLinConfig(
                                policy="sorted_tiled_seq", acc_bits=16,
                                k_tile=16), device="cpu")
        if tmodel.cfg.is_encoder_decoder:
            assert set(eng.caches) == {"self", "cross"}
            assert tuple(eng.caches["cross"][0]["k"].shape) == (
                3, 1500, tmodel.cfg.num_kv_heads,
                tmodel.cfg.resolved_head_dim)
        tr = reqs(Request)
        eng.drain(tr)
        assert [len(r.output) for r in tr] == [6, 4, 6, 5, 3]
        assert [r.output for r in tr] == [r.output for r in jr]


def test_engine_resets_every_cache_leaf():
    """An admission zeroes the slot in every leaf of the cache tree:
    jamba's KV and SSM caches, whisper's self and cross caches; the other
    slots keep theirs."""
    for arch in ("jamba-v0.1-52b", "whisper-medium"):
        model = build_model(_f32(get_config(arch, smoke=True)),
                            device="cpu")
        eng = ServingEngine(model, model.init(0), num_slots=2, max_len=32,
                            device="cpu")
        eng.caches = tree_map(torch.ones_like, eng.caches)
        eng._reset(np.array([True, False]))
        leaves = list(dict(_flat(eng.caches)).values())
        assert leaves and all(not leaf[0].any() and leaf[1].all()
                              for leaf in leaves)


def test_param_counts(family):
    for jtree, ttree in ((family["jf"], family["tf"]),
                         (family["jq"], family["tq"]),
                         (family["jc"], family["tc"])):
        total = jmodel_lib.param_count(jtree)
        assert tmodel_lib.param_count(ttree) == total
        assert tmodel_lib.active_param_count(family["tmodel"].cfg, total) \
            == jmodel_lib.active_param_count(family["jmodel"].cfg, total)
