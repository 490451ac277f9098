"""The port's smoke qwen2 model and ServingEngine against the JAX package.

Parameters come from the JAX init (float32 compute), quantized as
``examples/serve_quantized.py`` quantizes them, and reach the port as
numpy arrays through ``repro_torch.convert.params_from_numpy``.

Tolerances: float logits agree to atol 1e-4 — both packages run the same
float32 operations, but XLA and torch sum matmuls, means and softmaxes in
different orders, which moves the last bits (about 1e-6 relative on these
O(1) logits). Integer sites are exact on identical inputs (see
test_torch_qtensor.py); end to end the check is identical greedy tokens.
Sampled decode is compared only within the port: numpy generators are
seeded alike in both engines, but the logits they sample from differ in
the last bits, so cross-package sampling could legitimately diverge.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import dispatch as jd
from repro.core.qtensor import QTensor as JQTensor
from repro.core.qtensor import quantize_tree as jquantize_tree
from repro.models.model import build_model as jbuild_model
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import dispatch as td
from repro_torch.core.qtensor import QTensor
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServingEngine

ATOL = 1e-4


def _to_numpy(tree):
    if isinstance(tree, JQTensor):
        return {"values": np.array(tree.values), "scale": np.array(tree.scale)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    qparams = jquantize_tree(params, bits=8, n_keep=8, m=16,
                             min_size=1 << 12, min_dim=16)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(_to_numpy(qparams), device="cpu")
    return jmodel, qparams, tmodel, tparams


def _prompts(n, seed=0, lo=3, hi=12, vocab=256):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=int(r.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def test_conversion_layout(models):
    _, qparams, tmodel, tparams = models
    assert len(tparams["layers"]) == tmodel.cfg.num_layers
    attn = tparams["layers"][1]["attn"]
    assert isinstance(attn["wq"], QTensor)  # (2, 48, 48) stacked >= 4096
    assert not isinstance(attn["wk"], QTensor)  # (2, 48, 24) stays float
    np.testing.assert_array_equal(
        attn["wq"].values.numpy(),
        np.asarray(qparams["layers"]["attn"]["wq"].values[1]))


def _prefill_then_decode(model, params, caches, toks, lengths, nxt, ctx,
                         jax_side):
    with ctx():
        lp, caches = model.prefill(params, toks, caches, lengths)
        ld, _ = model.decode(params, nxt, caches)
    if jax_side:
        return np.asarray(lp), np.asarray(ld)
    return lp.numpy(), ld.numpy()


@pytest.mark.parametrize("integer", [False, True])
def test_prefill_and_decode_logits(models, integer):
    jmodel, qparams, tmodel, tparams = models
    r = np.random.default_rng(1)
    toks = r.integers(0, 256, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 0], np.int32)
    nxt = r.integers(0, 256, (3, 1)).astype(np.int32)
    jcfg = jd.IntegerLinConfig(policy="sorted_tiled_seq", acc_bits=16,
                               k_tile=16, backend="jnp")
    tcfg = td.IntegerLinConfig(policy="sorted_tiled_seq", acc_bits=16,
                               k_tile=16)
    jctx = (lambda: jd.integer_lin(jcfg)) if integer else contextlib.nullcontext
    tctx = (lambda: td.integer_lin(tcfg)) if integer else contextlib.nullcontext
    jl = _prefill_then_decode(
        jmodel, qparams, jmodel.init_caches(qparams, 3, 32, jnp.float32),
        jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(nxt), jctx, True)
    tl = _prefill_then_decode(
        tmodel, tparams, tmodel.init_caches(tparams, 3, 32, torch.float32),
        torch.from_numpy(toks), torch.from_numpy(lengths),
        torch.from_numpy(nxt), tctx, False)
    for j, t in zip(jl, tl):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def _serve_jax(jmodel, qparams, prompts, max_new=6):
    eng = JServingEngine(
        jmodel, qparams, num_slots=3, max_len=64,
        int_lin=jd.IntegerLinConfig(policy="sorted_tiled_seq", acc_bits=16,
                                    k_tile=16, backend="jnp"))
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    eng.drain(reqs)
    return [r.output for r in reqs]


def _serve_port(tmodel, tparams, prompts, max_new=6, temperature=0.0,
                num_slots=3, integer=True, order=None):
    int_lin = (td.IntegerLinConfig(policy="sorted_tiled_seq", acc_bits=16,
                                   k_tile=16) if integer else None)
    eng = ServingEngine(tmodel, tparams, num_slots=num_slots, max_len=64,
                        device="cpu", int_lin=int_lin)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new,
                    temperature=temperature)
            for i, p in enumerate(prompts)]
    eng.drain([reqs[i] for i in (order or range(len(reqs)))])
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], eng


def test_engine_greedy_tokens_match_jax(models):
    jmodel, qparams, tmodel, tparams = models
    prompts = _prompts(5, seed=2)  # 5 requests on 3 slots: slots refill
    want = _serve_jax(jmodel, qparams, prompts)
    got, eng = _serve_port(tmodel, tparams, prompts)
    assert got == want
    assert eng.stats["cohorts"] >= 2 and eng.stats["decode_steps"] > 0


def test_slot_isolation(models):
    """A prompt alone in the engine and beside others decodes the same.

    Checked on the dequantized float path. An integer step quantizes its
    activations with one absmax over every row, so there the neighbours'
    rows do change the activation codes, in both packages alike.
    """
    _, _, tmodel, tparams = models
    prompts = _prompts(4, seed=3)
    alone, _ = _serve_port(tmodel, tparams, prompts[:1], num_slots=4,
                           integer=False)
    beside, _ = _serve_port(tmodel, tparams, prompts, num_slots=4,
                            integer=False)
    assert beside[0] == alone[0]


def test_sampled_decode_reproducible_within_port(models):
    """Each request samples from its own (seed, uid) stream, whatever the
    admission order: the same rows reach every step, only permuted."""
    _, _, tmodel, tparams = models
    prompts = _prompts(3, seed=4)
    a, _ = _serve_port(tmodel, tparams, prompts, temperature=0.8)
    b, _ = _serve_port(tmodel, tparams, prompts, temperature=0.8,
                       order=[2, 0, 1])
    assert a == b
