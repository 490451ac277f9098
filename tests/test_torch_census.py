"""The overflow census on the port's serving path against the JAX package.

Inputs are seeded with numpy and reach both packages as arrays. Integer
results and census counts are held exact: ``pqs_dot(with_census=True)``
under every policy on dense, 8:16 and 2:4 storage (the JAX package on its
jnp backend, and its Pallas kernels in interpret mode on a few cases),
``qtensor_dot`` under ``census_monitor``, and ``attach_act_qparams``.

Float inputs enter in two places, each with its tolerance stated there:
``calibrate`` (activation ranges, rtol 1e-5) and the census-watched
engine (greedy tokens and the sites that degrade, compared exactly; the
float logits behind them agree to 1e-4 as in test_torch_serving.py).
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
from repro.core import dispatch as jd
from repro.core import pruning as jpr
from repro.core import qtensor as jqt
from repro.core.quant import activation_qparams, symmetric_activation_qparams
from repro.models.model import build_model as jbuild_model
from repro.serving import CensusWatch as JCensusWatch
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch as td
from repro_torch.core import qtensor as tqt
from repro_torch.core.quant import QParams
from repro_torch.models.model import build_model
from repro_torch.serving import CensusWatch, Request, ServingEngine

POLICIES = ("wide", "clip", "wrap", "sorted", "sorted_tiled",
            "sorted_tiled_seq")
STORAGES = ("dense", (8, 16), (2, 4))  # dense, or (n_keep, m_group)
ACC_BITS = (8, 12, 16)
SHAPES = ((3, 7, 100), (5, 4, 96), (1, 9, 33), (4, 5, 64))  # (M, N, K)
FIELDS = ("n_dots", "n_persistent", "n_transient", "n_any", "n_combine")
CASES = [(p, s) for p in POLICIES for s in STORAGES]


def _operands(m, n, k, storage, seed):
    """int8 x (m, k) and the weight: dense (n, k), or pruned by the JAX
    mask and compressed by the JAX packer: (dense, values, indices)."""
    r = np.random.default_rng(seed)
    x = r.integers(-128, 128, (m, k)).astype(np.int8)
    x[0] = 127  # a row whose registers saturate
    w = r.integers(-127, 128, (n, k))
    if storage == "dense":
        return x, w.astype(np.int8), None
    n_keep, mg = storage
    kp = k + (-k) % mg
    wp = np.pad(w, ((0, 0), (0, kp - k)))
    mask = np.asarray(jpr.nm_prune_mask(jnp.asarray(wp, jnp.float32),
                                        n_keep, mg))
    wd = (wp * mask).astype(np.int8)[:, :k]
    return x, wd, jpr.nm_compress(wd, n_keep, mg)


def _sparse(slabs, m_group, k):
    """The slabs as a SparseQTensor of logical K ``k`` in both packages."""
    vals, idx = (np.ascontiguousarray(a) for a in slabs)
    scale = np.ones(vals.shape[0], np.float32)
    return (jqt.SparseQTensor(jnp.asarray(vals), jnp.asarray(idx),
                              jnp.asarray(scale), m_group, k),
            tqt.SparseQTensor(torch.from_numpy(vals), torch.from_numpy(idx),
                              torch.from_numpy(scale), m_group, k))


def _census_ints(c):
    return [int(getattr(c, f)) for f in FIELDS]


def _both(x, wd, slabs, storage, backend="jnp", nm_impl=None, **kw):
    """(JAX out, JAX census, port out, port census) of one dot."""
    if slabs is None:
        jw, tw, nm = jnp.asarray(wd), torch.from_numpy(wd), {}
    else:
        jw, tw = _sparse(slabs, storage[1], wd.shape[1])
        nm = dict(storage="nm", nm_impl=nm_impl)
    jo, jc = jd.pqs_dot(jnp.asarray(x), jw, backend=backend,
                        with_census=True, **nm, **kw)
    to, tc = td.pqs_dot(torch.from_numpy(x), tw, with_census=True, **nm, **kw)
    return np.asarray(jo), _census_ints(jc), to.numpy(), _census_ints(tc)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pqs_dot_census_matches_jax(case):
    """Every policy on dense, 8:16 and 2:4 storage, ragged M/N/K, acc_bits
    8, 12 and 16 in turn: the output and all five census fields equal the
    JAX package's; the output is the one without the census."""
    policy, storage = CASES[case]
    m, n, k = SHAPES[case % len(SHAPES)]
    acc_bits = ACC_BITS[case % len(ACC_BITS)]
    x, wd, slabs = _operands(m, n, k, storage, seed=case)
    kw = dict(policy=policy, acc_bits=acc_bits, k_tile=16)
    nm_impl = None if slabs is None else ("gather", "expand")[case % 2]
    jo, jc, to, tc = _both(x, wd, slabs, storage, nm_impl=nm_impl, **kw)
    np.testing.assert_array_equal(to, jo)
    assert tc == jc
    assert jc[0] == m * n and jc[3] == jc[1] + jc[2]
    plain = td.pqs_dot(torch.from_numpy(x), torch.from_numpy(wd), **kw)
    np.testing.assert_array_equal(plain.numpy(), to)
    if slabs is not None:
        # the kept-only census equals the dense census on the same codes
        _, dc = td.pqs_dot(torch.from_numpy(x), torch.from_numpy(wd),
                           with_census=True, **kw)
        assert _census_ints(dc) == tc


@pytest.mark.parametrize("storage,nm_impl", [
    ("dense", None), ((8, 16), "gather"), ((8, 16), "expand"),
    ((2, 4), "expand")])
def test_census_matches_jax_pallas_interpret(storage, nm_impl):
    """The JAX package's Pallas kernels (interpret mode) and census."""
    x, wd, slabs = _operands(5, 6, 64, storage, seed=40)
    jo, jc, to, tc = _both(x, wd, slabs, storage, backend="pallas",
                           nm_impl=nm_impl, policy="sorted_tiled_seq",
                           acc_bits=12, k_tile=16)
    np.testing.assert_array_equal(to, jo)
    assert tc == jc and jc[3] > 0


@pytest.mark.parametrize("storage", STORAGES)
def test_census_budget_chunks_m(monkeypatch, storage):
    """A census budget of one byte (one row of x a chunk) gives the
    counts of one chunk: the counts are summed over M-chunks."""
    x, wd, slabs = _operands(7, 5, 96, storage, seed=50)
    tw = torch.from_numpy(wd) if slabs is None else _sparse(
        slabs, storage[1], wd.shape[1])[1]
    nm = {} if slabs is None else dict(storage="nm")
    kw = dict(policy="clip", acc_bits=12, with_census=True, **nm)
    out, whole = td.pqs_dot(torch.from_numpy(x), tw, **kw)
    monkeypatch.setattr(td, "_CENSUS_BUDGET", 1)
    out1, chunked = td.pqs_dot(torch.from_numpy(x), tw, **kw)
    assert torch.equal(out, out1)
    assert _census_ints(chunked) == _census_ints(whole)
    assert _census_ints(whole)[0] == 35 and _census_ints(whole)[3] > 0


def test_certified_with_census_raises():
    x = torch.zeros((2, 16), dtype=torch.int8)
    w = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="certified"):
        td.pqs_dot(x, w, certified=True, with_census=True)


def test_census_monitor_semantics():
    """Python ints and 0-d tensors (int32 and int64) sum per site; rates
    and drain read them as the JAX monitor does."""
    tmon, jmon = td.CensusMonitor(), jd.CensusMonitor()
    obs = [("w_out", 1000, 100), ("wq", torch.tensor(40, dtype=torch.int32),
                                   torch.tensor(0, dtype=torch.int32)),
           ("w_out", torch.tensor(24), torch.tensor(6, dtype=torch.int32)),
           ("wq", 8, torch.tensor(2))]
    for site, d, e in obs:
        tmon.observe(site, d, e)
        jmon.observe(site, int(d), int(e))
    assert tmon.totals() == jmon.totals() == {"w_out": (1024, 106),
                                               "wq": (48, 2)}
    assert tmon.rates() == jmon.rates()
    assert tmon.drain() == jmon.drain()
    assert tmon.totals() == {} and tmon.rates() == {}
    with td.census_monitor() as mon:
        assert td.census_monitor_store() is mon
    assert td.census_monitor_store() is None


def _w(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.1


def _x(seed):
    return np.random.default_rng(seed).standard_normal((2, 5, 96)).astype(
        np.float32) * 3.0


def _port_qt(jq):
    return params_from_numpy({"w": to_numpy(jq)}, device="cpu")["w"]


@pytest.mark.parametrize("policy", ["sorted_tiled_seq", "clip", "wide"])
@pytest.mark.parametrize("sparse", [False, True])
def test_qtensor_dot_census_matches_jax(policy, sparse):
    """Each site under ``census_monitor`` reports the JAX package's (dots,
    events) on the same float x: a census site its census, a ``wide``
    site (dots, 0), a certified site nothing; the outputs are equal."""
    from repro.core import certify as jcertify
    from repro_torch.convert import certificate_from_fields

    jx = _x(3)
    sites = {}
    for i, (site, acc, static) in enumerate((
            ("wq", 12, None), ("w_out", 16, "symmetric"),
            ("w_up", 12, "asymmetric"), ("wk", 30, None))):
        jq = jqt.quantize_weight(jnp.asarray(_w(10 + i, (96, 40))), 8,
                                 8 if sparse else None, 16)
        if sparse:
            jq = jqt.qtensor_nm_compress(jq, 8, 16)
        if static is not None:
            qp = (symmetric_activation_qparams if static == "symmetric"
                  else activation_qparams)(jnp.float32(-2.0),
                                           jnp.float32(5.0), 8)
            jq = jqt.attach_act_qparams({site: jq}, {site: qp})[site]
        sites[site] = (jq, acc)
    # the certificate covers wk only, served at 30 bits: its bound needs
    # about 22 at K = 96
    jcert = jcertify.certify_params({"wk": sites["wk"][0]}, 30)
    tcert = certificate_from_fields(dataclasses.asdict(jcert))
    base = dict(policy=policy, k_tile=16,
                site_acc_bits=tuple((s, a) for s, (_, a) in sites.items()))
    jcfg = jd.IntegerLinConfig(backend="jnp", certificate=jcert, **base)
    tcfg = td.IntegerLinConfig(certificate=tcert, **base)
    jmon, tmon = jd.CensusMonitor(), td.CensusMonitor()
    for site, (jq, _) in sites.items():
        with jd.census_monitor(jmon):
            want = jd.qtensor_dot(jnp.asarray(jx), jq, jcfg, site=site)
        with td.census_monitor(tmon):
            got = td.qtensor_dot(torch.from_numpy(jx), _port_qt(jq), tcfg,
                                 site=site)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jax.effects_barrier()
    totals = tmon.totals()
    assert totals == jmon.totals()
    assert "wk" not in totals and set(totals) == {"wq", "w_out", "w_up"}
    if policy == "wide":
        assert all(e == 0 for _, e in totals.values())
    else:
        assert totals["wq"][1] > 0  # 12 bits saturate on these rows


@pytest.fixture(scope="module")
def smoke():
    """The f32 smoke model of both packages and the JAX package's int8
    params (unpruned, as tests/test_serving_fleet.py quantizes them)."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    qparams = jqt.quantize_tree(params, bits=8, min_size=1 << 10, min_dim=16)
    tmodel = build_model(dataclasses.replace(
        get_config("qwen2-1.5b", smoke=True), compute_dtype="float32"),
        device="cpu")
    return jmodel, qparams, tmodel, params


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("symmetric", [True, False])
def test_attach_act_qparams_matches_jax(smoke, sparse, symmetric):
    """Every layer's leaf of a site gets the site's QParams; act_corr (the
    kept-only sum for compressed storage) is the JAX package's, exact."""
    _, qparams, _, params = smoke
    if sparse:
        qparams = jqt.nm_compress_tree(jqt.quantize_tree(
            params, bits=8, n_keep=8, m=16, min_size=1 << 10, min_dim=16),
            8, 16)
    make = symmetric_activation_qparams if symmetric else activation_qparams
    frozen = {"wq": make(jnp.float32(-1.5), jnp.float32(2.5), 8),
              "w_out": make(jnp.float32(-0.25), jnp.float32(7.0), 8)}
    want = params_from_numpy(to_numpy(jqt.attach_act_qparams(qparams,
                                                             frozen)),
                             device="cpu")
    tfrozen = {s: QParams(torch.from_numpy(np.array(q.scale)),
                          torch.from_numpy(np.array(q.offset)), q.bits,
                          q.symmetric) for s, q in frozen.items()}
    got = tqt.attach_act_qparams(
        params_from_numpy(to_numpy(qparams), device="cpu"), tfrozen)
    for layer_got, layer_want in zip(got["layers"], want["layers"]):
        for sec, site in (("attn", "wq"), ("mlp", "w_out"),
                          ("mlp", "w_gate")):
            g, w = layer_got[sec][site], layer_want[sec][site]
            assert isinstance(g, tqt.SparseQTensor) == sparse
            if w.act_qparams is None:
                assert g.act_qparams is None and g.act_corr is None
                continue
            assert g.act_qparams.bits == w.act_qparams.bits
            assert g.act_qparams.symmetric == w.act_qparams.symmetric
            assert torch.equal(g.act_qparams.scale, w.act_qparams.scale)
            assert torch.equal(g.act_qparams.offset, w.act_qparams.offset)
            if symmetric:
                assert g.act_corr is None and w.act_corr is None
            else:
                assert g.act_corr.dtype == torch.int32
                assert torch.equal(g.act_corr, w.act_corr)
    assert got["embed"].act_qparams is None  # not a calibrated site


CAL = np.arange(32).reshape(2, 16) % 97 + 1  # the JAX tests' batch


def _engines(smoke, watch, jparams=None):
    """The JAX engine (on ``jparams``, or the smoke params) and the port's
    on the converted smoke params: sorted_tiled_seq at 17 bits, k_tile
    64, 4 slots."""
    jmodel, qparams, tmodel, _ = smoke
    jeng = JServingEngine(
        jmodel, qparams if jparams is None else jparams, num_slots=4,
        max_len=48, census_watch=watch[0], int_lin=jd.IntegerLinConfig(
            policy="sorted_tiled_seq", acc_bits=17, k_tile=64,
            backend="jnp"))
    teng = ServingEngine(
        tmodel, params_from_numpy(to_numpy(qparams if jparams is None
                                           else jparams), device="cpu"),
        num_slots=4, max_len=48, device="cpu", census_watch=watch[1],
        int_lin=td.IntegerLinConfig(policy="sorted_tiled_seq", acc_bits=17,
                                    k_tile=64))
    return jeng, teng


@pytest.mark.parametrize("symmetric", [True, False])
def test_calibrate_matches_jax(smoke, symmetric):
    """The frozen QParams of one calibration batch. Tolerance: the two
    packages sum float32 matmuls, means and softmaxes in different
    orders, so an activation's range moves in its last bits (about 1e-6
    relative); a scale is a ratio of those, held to rtol 1e-5, and an
    offset (a rounded ratio) exactly."""
    jeng, teng = _engines(smoke, (None, None))
    want = jeng.calibrate([{"tokens": jnp.asarray(CAL, jnp.int32)}],
                          symmetric=symmetric)
    got = teng.calibrate([{"tokens": CAL.astype(np.int32)}],
                         symmetric=symmetric)
    assert set(got) == set(want) == {"wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_out"}
    for site, q in want.items():
        g = got[site]
        assert (g.bits, g.symmetric) == (q.bits, q.symmetric)
        np.testing.assert_allclose(g.scale.numpy(), np.asarray(q.scale),
                                   rtol=1e-5, atol=0)
        assert int(g.offset) == int(q.offset)
    leaf = teng.params["layers"][1]["mlp"]["w_out"]
    assert leaf.act_qparams.bits == 8
    assert (leaf.act_corr is None) == symmetric


def _requests(cls):
    return [cls(uid=i, prompt=np.asarray([1 + i, 2, 3 + i, 5], np.int32),
                max_new_tokens=20) for i in range(4)]


def _drift(params, factor, needle="w_up"):
    """w_up's dequant scale inflated after calibration: w_out's input
    (silu(gate) * up) leaves the frozen static range, every rmsnorm
    shielded site stays in it."""
    def fix(path, leaf):
        if jqt.is_qtensor(leaf) and any(needle in str(p) for p in path):
            return dataclasses.replace(leaf, scale=leaf.scale * factor)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, params,
                                            is_leaf=jqt.is_qtensor)


@pytest.mark.parametrize("drifted", [False, True])
def test_census_degradation_fires_on_drifted_workload(smoke, drifted):
    """tests/test_serving_fleet.py's scenario (acc_bits 17, k_tile 64,
    w_up's scale x 8 after calibration) in both packages, the port served
    with the JAX-frozen QParams carried across: in range nothing
    degrades; drifted, exactly w_out degrades in both, to rate 0.0, the
    other sites keep sorted_tiled_seq, and the tokens are the same."""
    watch = (JCensusWatch(threshold=0.01, window=4),
             CensusWatch(threshold=0.01, window=4))
    jeng, _ = _engines(smoke, (None, None))
    jeng.calibrate([{"tokens": jnp.asarray(CAL, jnp.int32)}])
    frozen = _drift(jeng.params, 8) if drifted else jeng.params
    jeng, teng = _engines(smoke, watch, jparams=frozen)
    jreqs, treqs = _requests(JRequest), _requests(Request)
    jeng.drain(jreqs)
    teng.drain(treqs)
    assert all(r.done for r in jreqs + treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    want = {"w_out"} if drifted else set()
    assert teng._degraded == jeng._degraded == want
    assert teng.stats["census_degrades"] == len(want)
    events = [e for e in teng.events if e["event"] == "census_degrade"]
    assert [e["site"] for e in events] == sorted(want)
    assert [(e["site"], e["step"]) for e in events] == [
        (e["site"], e["step"]) for e in jeng.events]
    for site in ("wq", "wk", "wv", "wo", "w_gate", "w_up"):
        assert teng.int_lin.policy_for(site) == "sorted_tiled_seq"
    if drifted:
        assert events[0]["rate"] > 0.01
        assert teng.int_lin.policy_for("w_out") == "wide"
        assert teng.last_census_rates["w_out"] == 0.0
    assert set(teng.last_census_rates) == set(jeng.last_census_rates)


@pytest.mark.parametrize("mode", ["wide", "widen"])
def test_census_undegrade_after_clean_windows(smoke, mode):
    """tests/test_serving_fleet.py's undegrade sequence (its snapshot /
    restore tail waits for the port's snapshot) in both packages, in
    both modes: the same events, streaks and overrides."""
    kw = dict(threshold=0.01, window=1, min_dots=10, undegrade_after=2,
              mode=mode)
    jeng, teng = _engines(smoke, (JCensusWatch(**kw), CensusWatch(**kw)))
    swapped = (("policy_for", "wide") if mode == "wide"
               else ("acc_bits_for", 30))

    def window(dots, events):
        for eng in (jeng, teng):
            eng._census.observe("w_out", dots, events)
            eng._check_census()
        assert teng._degraded == jeng._degraded
        assert teng._clean_windows == jeng._clean_windows
        assert teng.int_lin.site_policies == jeng.int_lin.site_policies
        assert teng.int_lin.site_acc_bits == jeng.int_lin.site_acc_bits

    window(1000, 100)  # hot: w_out degrades
    assert teng._degraded == {"w_out"}
    assert getattr(teng.int_lin, swapped[0])("w_out") == swapped[1]
    window(1000, 0)  # clean: the streak advances, still degraded
    assert teng._clean_windows["w_out"] == 1
    window(9, 0)  # under min_dots: the streak is frozen
    assert teng._clean_windows["w_out"] == 1
    window(1000, 500)  # dirty: the streak resets
    assert teng._degraded == {"w_out"} and teng._clean_windows["w_out"] == 0
    window(1000, 0)
    window(1000, 0)  # two clean windows: the reverse transition
    assert teng._degraded == set()
    assert teng.stats["census_undegrades"] == 1
    assert teng.stats["census_degrades"] == 1
    assert teng.events == jeng.events
    (ev,) = [e for e in teng.events if e["event"] == "census_undegrade"]
    assert ev["site"] == "w_out" and ev["clean_windows"] == 2
    assert teng.int_lin.policy_for("w_out") == "sorted_tiled_seq"
    assert teng.int_lin.acc_bits_for("w_out") == 17


def test_census_watch_needs_int_lin(smoke):
    _, qparams, tmodel, _ = smoke
    with pytest.raises(ValueError, match="int_lin"):
        ServingEngine(tmodel, params_from_numpy(to_numpy(qparams),
                                                device="cpu"),
                      num_slots=1, max_len=8, device="cpu",
                      census_watch=CensusWatch())
