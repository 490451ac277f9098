"""Accumulator-safety certification in the port against the JAX package.

Host numpy int64 on both sides, so everything here is exact: the row
bounds, the truncation, the certificates field by field (weight hashes
included) on the converted smoke weights, dense and compressed, and a
certificate issued by the JAX package verifying on the port's weights,
carried across by its plain fields (the port never unpickles a JAX
class). Certified dispatch is held bit-identical to the narrow policies
on enforced rows, and the certified engine census-free and token for
token equal to the censused engine on the same weights
(tests/test_certify.py's acceptance scenario without the fleet).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_to_port import to_numpy

import repro.core  # noqa: F401  (imports the JAX package in its own order)
from repro.configs import get_config as jget_config
from repro.core import certify as jcertify
from repro.core import qtensor as jqt
from repro.models.model import build_model as jbuild_model
from repro.runtime import quantize_and_certify
from repro_torch.configs import get_config
from repro_torch.convert import certificate_from_fields, params_from_numpy
from repro_torch.core import certify as tcertify
from repro_torch.core import dispatch as td
from repro_torch.core import qtensor as tqt
from repro_torch.models.model import build_model
from repro_torch.serving import CensusWatch, Request, ServingEngine

POLICIES = ("wide", "clip", "wrap", "sorted", "sorted_tiled",
            "sorted_tiled_seq")


@pytest.mark.parametrize("k,act_bits,seed", [(7, 8, 0), (33, 4, 1),
                                             (64, 8, 2), (1536, 8, 3)])
def test_row_bounds_match_jax(k, act_bits, seed):
    wq = np.random.default_rng(seed).integers(-127, 128, (6, k))
    tpos, tneg = tcertify.row_excursions(wq, act_bits)
    jpos, jneg = jcertify.row_excursions(wq, act_bits)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tneg, jneg)
    assert tcertify.min_acc_bits(tpos, tneg) == \
        jcertify.min_acc_bits(jpos, jneg)
    assert tcertify.acc_caps(16) == jcertify.acc_caps(16) == (32767, 32768)


@pytest.mark.parametrize("acc_bits,act_bits", [(12, 8), (14, 8), (16, 4),
                                               (24, 8)])
def test_truncate_rows_matches_jax(acc_bits, act_bits):
    wq = np.random.default_rng(acc_bits).integers(-127, 128, (16, 256)
                                                  ).astype(np.int8)
    got = tcertify.truncate_rows(wq, acc_bits, act_bits)
    np.testing.assert_array_equal(got, jcertify.truncate_rows(
        wq, acc_bits, act_bits))
    assert got.dtype == np.int8
    pos, neg = tcertify.row_excursions(got, act_bits)
    cap_pos, cap_neg = tcertify.acc_caps(acc_bits)
    assert (pos <= cap_pos).all() and (neg <= cap_neg).all()
    np.testing.assert_array_equal(
        tcertify.truncate_rows(got, acc_bits, act_bits), got)


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(
        get_config("qwen2-1.5b", smoke=True), compute_dtype="float32"),
        device="cpu")
    return jmodel, params, tmodel


def _trees(params, storage):
    """A JAX quantized tree of the smoke params: dense int8, 8:16
    compressed, or with the quantized layer-stacked vectors (biases and
    norms, min_dim 2) whose rows run across the layers; with frozen
    asymmetric QParams (and so act_corr) on wq and w_out."""
    from repro.core.quant import activation_qparams

    min_dim = 2 if storage == "rows" else 16
    q = jqt.quantize_tree(params, bits=8,
                          n_keep=8 if storage == "nm" else None, m=16,
                          min_size=1 << 6, min_dim=min_dim)
    if storage == "nm":
        q = jqt.nm_compress_tree(q, 8, 16)
    return jqt.attach_act_qparams(q, {
        "wq": activation_qparams(jnp.float32(-1.0), jnp.float32(3.0), 8),
        "w_out": activation_qparams(jnp.float32(-0.5), jnp.float32(6.0), 7)})


def _port(tree):
    return params_from_numpy(to_numpy(tree), device="cpu")


@pytest.mark.parametrize("storage", ["dense", "nm", "rows"])
def test_certify_params_matches_jax(smoke, storage):
    """The port's certificate of the converted weights equals the JAX
    package's field by field, weight hashes included, and each verifies
    the other package's weights."""
    _, params, _ = smoke
    jq = _trees(params, storage)
    tq = _port(jq)
    if storage == "rows":
        row = tq["layers"][0]["attn"]["bq"]
        assert isinstance(row, tqt.QTensor) and row.ndim == 1
    for acc_bits in (16, 24):
        jc = jcertify.certify_params(jq, acc_bits, 8)
        tc = tcertify.certify_params(tq, acc_bits, 8)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.summary() == jc.summary()
        tc.verify(tq)
        certificate_from_fields(dataclasses.asdict(jc)).verify(tq)
        jcertify.Certificate(
            sites=tuple(jcertify.SiteCertificate(**dataclasses.asdict(sc))
                        for sc in tc.sites), acc_bits=tc.acc_bits).verify(jq)
    assert {"wq", "w_out", "embed"} <= {sc.site for sc in tc.sites}
    assert tc.site("w_out").act_bits == 8  # max of its frozen 7 and 8


@pytest.mark.parametrize("storage", ["dense", "nm", "rows"])
def test_enforce_acc_bounds_matches_jax(smoke, storage):
    """Truncated codes and recomputed act_corr equal the JAX package's,
    layer by layer; the result certifies at the target."""
    _, params, _ = smoke
    jq = _trees(params, storage)
    want = _port(jcertify.enforce_acc_bounds(jq, 14, 8))
    got = tcertify.enforce_acc_bounds(_port(jq), 14, 8)
    for path, g, w in _leaves(got, want):
        assert type(g) is type(w), path
        assert torch.equal(g.values, w.values), path
        if isinstance(g, tqt.QTensor) and g.ndim >= 2:
            assert torch.equal(g.values_t, g.values.T), path
        assert (g.act_corr is None) == (w.act_corr is None), path
        if g.act_corr is not None:
            assert torch.equal(g.act_corr, w.act_corr), path
    cert = tcertify.certify_params(got, 14, 8)
    assert all(sc.acc_bits_safe <= 14 for sc in cert.sites)


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}/{i}")
    elif tqt.is_qtensor(a):
        yield path, a, b


@pytest.fixture(scope="module")
def certified24(smoke):
    """tests/test_certify.py's fixture: quantize, enforce and certify the
    smoke params at acc_bits 24 in the JAX package."""
    _, params, _ = smoke
    return quantize_and_certify(params, acc_bits=24)


def _tamper(tree, needle="w_up"):
    """One integer code of every ``needle`` leaf moved by one."""
    def fix(path, leaf):
        if jqt.is_qtensor(leaf) and any(needle in str(p) for p in path):
            v = np.asarray(leaf.values).copy()
            v.flat[0] = v.flat[0] + 1 if v.flat[0] < 127 else v.flat[0] - 1
            return dataclasses.replace(leaf, values=jnp.asarray(v))
        return leaf

    return jax.tree_util.tree_map_with_path(fix, tree, is_leaf=jqt.is_qtensor)


def test_jax_certificate_verifies_on_port(smoke, certified24):
    """A JAX-issued certificate, carried by its fields, verifies on the
    converted weights; one tampered code raises, in ``verify`` and at
    engine construction; scale drift does not."""
    _, _, tmodel = smoke
    jq, jcert = certified24
    cert = certificate_from_fields(dataclasses.asdict(jcert))
    tq = _port(jq)
    cert.verify(tq)
    drifted = _port(jq)
    drifted["layers"][1]["mlp"]["w_up"].scale.mul_(8)
    cert.verify(drifted)
    tampered = _port(_tamper(jq))
    with pytest.raises(tcertify.CertificateError, match="w_up"):
        cert.verify(tampered)
    il = td.IntegerLinConfig(acc_bits=24, k_tile=64, certificate=cert)
    with pytest.raises(tcertify.CertificateError):
        ServingEngine(tmodel, tampered, num_slots=2, max_len=48,
                      device="cpu", int_lin=il)
    ServingEngine(tmodel, tq, num_slots=2, max_len=48, device="cpu",
                  int_lin=il)


def test_certificate_covers_semantics(certified24):
    _, jcert = certified24
    cert = certificate_from_fields(dataclasses.asdict(jcert))
    sc = cert.site("w_out")
    assert sc is not None and sc.acc_bits_safe <= 24
    assert cert.covers("w_out", 24, 8)
    assert cert.covers("w_out", 30, 8)  # a wider register: still safe
    assert cert.covers("w_out", 24, 4)  # narrower codes: a subset
    assert not cert.covers("w_out", sc.acc_bits_safe - 1, 8)
    assert not cert.covers("w_out", 24, 9)  # wider codes than certified
    assert not cert.covers("nonexistent_site", 24, 8)
    for name in ("w_out", "wq", "nonexistent_site"):
        for acc, act in ((24, 8), (sc.acc_bits_safe - 1, 8), (24, 9)):
            assert cert.covers(name, acc, act) == jcert.covers(name, acc,
                                                               act)


def test_certificate_leaf_roundtrip(certified24):
    """to_leaf / from_leaf round trip; a JAX package blob is refused
    without unpickling its class."""
    jq, jcert = certified24
    cert = certificate_from_fields(dataclasses.asdict(jcert))
    leaf = cert.to_leaf()
    assert isinstance(leaf, np.ndarray) and leaf.dtype == np.uint8
    back = tcertify.Certificate.from_leaf(leaf)
    assert back == cert and back.sites == cert.sites
    back.verify(_port(jq))
    with pytest.raises(tcertify.CertificateError, match="repro.core"):
        tcertify.Certificate.from_leaf(jcert.to_leaf())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("storage", ["dense", "nm"])
def test_certified_dispatch_bit_identical(policy, storage):
    """On rows enforced to 14 bits the census reads no event and the
    certified dot equals the narrow one (and the JAX package's)."""
    from repro.core.dispatch import pqs_dot as jpqs_dot

    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (5, 96)).astype(np.int8)
    w = tcertify.truncate_rows(rng.integers(-127, 128, (7, 96)).astype(
        np.int32), 14, 8).astype(np.int8)
    kw = dict(acc_bits=14, policy=policy, k_tile=32)
    tw = torch.from_numpy(w)
    if storage == "nm":
        w = (w * np.tile([1, 0], 48)).astype(np.int8)  # 8:16 pruned
        tw = tqt.qtensor_nm_compress(tqt.QTensor(
            torch.from_numpy(np.ascontiguousarray(w.T)),
            torch.ones(7)), 8, 16)
        kw["storage"] = "nm"
    ref, cns = td.pqs_dot(torch.from_numpy(x), tw, with_census=True, **kw)
    out = td.pqs_dot(torch.from_numpy(x), tw, certified=True, **kw)
    assert int(cns.n_any) == 0
    assert torch.equal(out, ref)
    jout = jpqs_dot(jnp.asarray(x), jnp.asarray(w), acc_bits=14,
                    policy=policy, k_tile=32, backend="jnp", certified=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


CAL = np.arange(32).reshape(2, 16) % 97 + 1


def _reqs():
    return [Request(uid=i, prompt=np.asarray([1 + i, 2, 3 + i, 5], np.int32),
                    max_new_tokens=20) for i in range(4)]


def test_certified_engine_census_free_and_bit_identical(smoke, certified24):
    """tests/test_certify.py's acceptance gate without the fleet, on the
    JAX package's enforced weights and certificate carried across: under
    a drifted workload the certified engine decodes with no census entry
    and no degrade, token for token as the censused engine on the same
    weights (which reads no event), while the uncertified 17-bit engine
    on the plain int8 weights degrades w_out."""
    _, params, tmodel = smoke
    jq, jcert = certified24
    cert = certificate_from_fields(dataclasses.asdict(jcert))
    watch = CensusWatch(threshold=0.01, window=4)

    def build(tree, acc_bits, certificate):
        eng = ServingEngine(
            tmodel, _port(tree), num_slots=4, max_len=48, device="cpu",
            census_watch=watch, int_lin=td.IntegerLinConfig(
                policy="sorted_tiled_seq", acc_bits=acc_bits, k_tile=64,
                certificate=certificate))
        eng.calibrate([{"tokens": CAL.astype(np.int32)}])
        # w_up's dequant scale x 8 after calibration: w_out's input
        # leaves the frozen range on every engine alike
        for layer in eng.params["layers"]:
            w_up = layer["mlp"]["w_up"]
            layer["mlp"]["w_up"] = dataclasses.replace(
                w_up, scale=w_up.scale * 8)
        return eng

    plain17 = jqt.quantize_tree(params, bits=8, min_size=1 << 10, min_dim=16)
    runs = {}
    for name, tree, acc, c in (("certified", jq, 24, cert),
                               ("censused", jq, 24, None),
                               ("uncertified", plain17, 17, None)):
        eng = build(tree, acc, c)
        reqs = _reqs()
        eng.drain(reqs)
        assert all(r.done for r in reqs)
        runs[name] = (eng, [r.output for r in reqs])
    certified, censused = runs["certified"][0], runs["censused"][0]
    assert certified.stats["census_degrades"] == 0
    assert certified.events == [] and certified._degraded == set()
    assert certified.last_census_rates == {}
    assert certified._census.totals() == {}
    assert censused.stats["census_degrades"] == 0
    assert set(censused.last_census_rates) == {
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_out"}
    assert all(r == 0.0 for r in censused.last_census_rates.values())
    assert runs["certified"][1] == runs["censused"][1]
    uncert = runs["uncertified"][0]
    assert uncert._degraded == {"w_out"}
    (event,) = [e for e in uncert.events if e["event"] == "census_degrade"]
    assert event["site"] == "w_out"
