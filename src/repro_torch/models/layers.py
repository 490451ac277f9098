"""Model-zoo layers: norms, RoPE and M-RoPE, GQA self- and
cross-attention, MLP; torch port of ``repro.models.layers``.

Plain functions on tensors. Params are dicts of tensors, one dict per
layer. Activations flow in the compute dtype; norms and softmax run in
f32. Any projection may be a QTensor or a SparseQTensor: ``lin``
dequantizes it, or inside ``core.dispatch.integer_lin`` runs it as an
integer PQS dot (and inside ``core.dispatch.calibration`` reports its
input's range first). Attention is plain einsum/softmax, as the JAX
package leaves it to XLA, over query chunks of ``cfg.attn_chunk_q`` from
``cfg.attn_chunk_threshold`` tokens. A layer's sliding window is a static
argument (the layer loop is Python; the JAX package's traced
``use_window`` flag selects the same mask in its scan), and its decode
cache is a ring of ``min(s_max, window)`` slots. Positions are (B, S),
or (3, B, S) t / h / w streams under M-RoPE (``cfg.mrope_sections``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch
from repro_torch.core.qtensor import asarray, is_qtensor

Params = dict[str, Any]


def lin(x: torch.Tensor, w: Any, site: Optional[str] = None) -> torch.Tensor:
    """x @ w, with QTensor and SparseQTensor weights run as integer dots
    inside an ``integer_lin`` context and dequantized otherwise. Inside
    ``dispatch.calibration`` a named site first reports its input's
    float32 (min, max) to the store. Inside ``dispatch.a2q_qat`` a named
    site's float 2-D weight with min(shape) >= the config's ``min_dim``
    runs ``dispatch.a2q_qat_lin`` (accumulator-aware fake quantization);
    smaller weights and unnamed sites stay float."""
    if isinstance(w, torch.Tensor):
        if w.ndim == 2 and site is not None:
            qat = dispatch.a2q_qat_config()
            if qat is not None and min(w.shape) >= qat.min_dim:
                return dispatch.a2q_qat_lin(x, w, qat, site=site)
    elif is_qtensor(w):
        store = dispatch.calibration_store()
        if store is not None and site is not None:
            xf = x.to(torch.float32)
            store.observe(site, xf.min(), xf.max())
        cfg = dispatch.integer_lin_config()
        if cfg is not None:
            return dispatch.qtensor_dot(x, w, cfg, site=site)
    return x @ asarray(w, x.dtype)


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim, out_dim, dtype, device,
               scale=None):
    scale = scale if scale is not None else (2.0 / (in_dim + out_dim)) ** 0.5
    return torch.randn((in_dim, out_dim), generator=gen, dtype=dtype,
                       device=device) * scale


def norm_init(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)  # scale - 1


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: Any, eps: float = 1e-6):
    """gamma may be a QTensor row, as a bias may (``quantize_tree``)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + asarray(gamma, torch.float32))
    return out.to(dt)


def layer_norm(x: torch.Tensor, gamma: Any, eps: float = 1e-5):
    """Layer norm without a bias (command-r), gamma stored as scale - 1."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * (
        1.0 + asarray(gamma, torch.float32))
    return out.to(dt)


def norm(x: torch.Tensor, gamma: Any, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, gamma) if cfg.norm == "rmsnorm" else layer_norm(
        x, gamma)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim // 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i * 2 / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, head_dim: int,
               theta: float,
               mrope_sections: Optional[tuple[int, ...]] = None
               ) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) int, or (3, B, S) under M-RoPE:
    the head_dim / 2 frequency slots split into t / h / w sections
    (``mrope_sections``), each slot rotated by its own stream."""
    freqs = rope_freqs(head_dim, theta, x.device)
    if mrope_sections is not None:
        assert positions.ndim == 3 and positions.shape[0] == 3
        sec = torch.cat([torch.full((n,), i, dtype=torch.int64,
                                    device=x.device)
                         for i, n in enumerate(mrope_sections)])
        angles = positions.to(torch.float32)[..., None] * freqs
        angles = angles.movedim(0, -1)  # (B, S, hd/2, 3)
        angles = torch.gather(
            angles, -1, sec.expand(angles.shape[:-1])[..., None])[..., 0]
    else:
        assert positions.ndim == 2
        angles = positions.to(torch.float32)[..., None] * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, g = cfg.num_heads, cfg.num_kv_heads
    dt = getattr(torch, cfg.param_dtype)
    p: Params = {
        "wq": dense_init(gen, d, h * hd, dt, device),
        "wk": dense_init(gen, d, g * hd, dt, device),
        "wv": dense_init(gen, d, g * hd, dt, device),
        "wo": dense_init(gen, h * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((g * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((g * hd,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, device)
        p["k_norm"] = norm_init(hd, device)
    return p


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int] = None):
    """(Sq, Sk) boolean mask: True = attend; a query sees the keys less
    than ``window`` positions behind it."""
    diff = q_pos[:, None] - k_pos[None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        m = m & (diff >= 0)
    if window is not None:
        m = m & (diff < window)
    return m


def _softcap(scores: torch.Tensor, softcap: Optional[float]):
    return scores if softcap is None else torch.tanh(
        scores / softcap) * softcap


def _sdpa(q, k, v, mask, softcap=None):
    """Attention with unexpanded GQA KV: q (B,Sq,H,hd), k/v (B,Sk,G,hd).

    Decode (Sq == 1) keeps KV unexpanded; Sq > 1 repeats each KV head
    H/G times, as the JAX package does. Scores are soft-capped (tanh(s /
    c) c) after the 1/sqrt(hd) scale; masked scores are -1e30.
    """
    b, sq, h, hd = q.shape
    g = k.shape[2]
    rep = h // g
    if sq > 1 and rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        g, rep = h, 1
    qg = q.reshape(b, sq, g, rep, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).to(torch.float32)
    scores = _softcap(scores / (hd**0.5), softcap)
    if mask.ndim == 2:
        mask = mask[None, None, None]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window, softcap, chunk):
    """``_sdpa`` over query chunks of ``chunk`` rows (one chunk when it is
    the whole sequence): the scores peak at (B, H, chunk, Sk) instead of
    (B, H, Sq, Sk); each query row's math is the unchunked one's."""
    sq = q.shape[1]
    assert sq % chunk == 0, (sq, chunk)
    return torch.cat([
        _sdpa(q[:, i : i + chunk], k, v,
              _attn_mask(q_pos[i : i + chunk], k_pos, causal, window),
              softcap)
        for i in range(0, sq, chunk)], dim=1)


def _qkv(params: Params, x: torch.Tensor, cfg: ModelConfig, positions,
         src: Optional[torch.Tensor] = None):
    """q (B, S, H, hd) from x and k, v (B, Sk, G, hd) from ``src`` (x by
    default; the encoder states of a cross-attention): projected, biased,
    QK-normed over head_dim (always ``rms_norm``, as in the JAX package),
    then rotated at ``positions`` unless they are None (k and v
    unexpanded)."""
    b, s, _ = x.shape
    src = x if src is None else src
    sk = src.shape[1]
    h, g, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = lin(x, params["wq"], site="wq")
    k = lin(src, params["wk"], site="wk")
    v = lin(src, params["wv"], site="wv")
    if cfg.qkv_bias:
        # asarray: a bias quantized with its layer stack is a QTensor row
        q = q + asarray(params["bq"], x.dtype)
        k = k + asarray(params["bk"], x.dtype)
        v = v + asarray(params["bv"], x.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, sk, g, hd)
    v = v.reshape(b, sk, g, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions is not None:
        q = apply_rope(q, positions, hd, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def attention(params: Params, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, causal: bool = True,
              window: Optional[int] = None,
              kv_x: Optional[torch.Tensor] = None, use_rope: bool = True,
              return_kv: bool = False):
    """Full-sequence attention (prefill, no cache), local over ``window``
    positions when given. With ``kv_x`` it is a cross-attention: keys and
    values from ``kv_x``, no causal mask, no rotation. ``use_rope=False``
    leaves the positions out (jamba's and whisper's layers).
    ``return_kv`` also returns the unexpanded post-RoPE (k, v) (B, Sk, G,
    hd). The query positions are the first sequence's (t's under
    M-RoPE), shared across the batch."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg,
                   positions if use_rope and kv_x is None else None, kv_x)
    pos1d = positions[0] if positions.ndim == 3 else positions
    q_pos = pos1d[0]  # (S,)
    k_pos = q_pos if kv_x is None else torch.arange(k.shape[1],
                                                    device=x.device)
    chunk = (cfg.attn_chunk_q if s >= cfg.attn_chunk_threshold
             and s % cfg.attn_chunk_q == 0 else s)
    o = _sdpa_chunked(q, k, v, q_pos, k_pos, causal and kv_x is None,
                      window, cfg.attn_logit_softcap, chunk)
    out = lin(o.reshape(b, s, h * hd), params["wo"], site="wo")
    return (out, (k, v)) if return_kv else out


def attention_decode(params: Params, x: torch.Tensor, cache: dict,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     use_rope: bool = True):
    """Single-token decode against a dense KV cache {"k","v": (B, S_max,
    G, hd), "pos": (B,)}; returns (out, new_cache). The new cache is a
    copy: the engine merges old and new lanes by slot. A sliding-window
    layer's cache is a ring: position p is written at p mod S_max, and a
    slot is valid when it holds one of the last min(pos + 1, window)
    writes. Under M-RoPE all three streams take the cache position."""
    b, one, _ = x.shape
    assert one == 1
    h, g, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pos = cache["pos"]  # (B,) next write index per sequence
    s_max = cache["k"].shape[1]
    pvec = None
    if use_rope:
        pvec = pos[:, None].to(torch.int32)  # (B, 1)
        if cfg.mrope_sections is not None:
            pvec = pvec.expand((3,) + pvec.shape)
    q, k, v = _qkv(params, x, cfg, pvec)

    rows = torch.arange(b, device=x.device)
    # a ring wraps (remainder, not fmod: jnp.mod's sign rule); past the end
    # of a global layer's cache the write drops, as JAX's scatter does
    idx = (torch.remainder(pos, s_max) if window is not None
           else torch.clamp(pos, max=s_max - 1))
    inb = ((pos < s_max) | (window is not None))[:, None, None]

    def write(c, new):
        out = c.clone()
        out[rows, idx] = torch.where(inb, new[:, 0].to(c.dtype), c[rows, idx])
        return out

    new_k, new_v = write(cache["k"], k), write(cache["v"], v)
    new_cache = {"k": new_k, "v": new_v, "pos": pos + 1}
    kk = new_k.to(x.dtype)  # (B, S_max, G, hd), never expanded
    vv = new_v.to(x.dtype)
    slot = torch.arange(s_max, device=x.device)
    if window is not None:
        age = torch.remainder(idx[:, None] - slot[None, :], s_max)
        valid = age < torch.clamp(pos + 1, max=window)[:, None]
    else:
        valid = slot[None, :] <= pos[:, None]
    qg = q.reshape(b, 1, g, h // g, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, kk).to(torch.float32)
    scores = _softcap(scores / (hd**0.5), cfg.attn_logit_softcap)
    scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bgrqk,bkgd->bqgrd", probs, vv)
    out = lin(o.reshape(b, 1, h * hd), params["wo"], site="wo")
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP and caches
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)
    if cfg.activation == "gelu_plain":
        return {
            "w_in": dense_init(gen, d, ff, dt, device),
            "b_in": torch.zeros((ff,), dtype=dt, device=device),
            "w_out": dense_init(gen, ff, d, dt, device),
            "b_out": torch.zeros((d,), dtype=dt, device=device),
        }
    return {
        "w_gate": dense_init(gen, d, ff, dt, device),
        "w_up": dense_init(gen, d, ff, dt, device),
        "w_out": dense_init(gen, ff, d, dt, device),
    }


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated SiLU / GELU, or the plain GELU MLP with biases; GELU is the
    tanh form, as ``jax.nn.gelu``'s default."""
    if cfg.activation == "gelu_plain":
        hid = lin(x, params["w_in"], site="w_in") + asarray(
            params["b_in"], x.dtype)
        hid = F.gelu(hid, approximate="tanh")
        return lin(hid, params["w_out"], site="w_out") + asarray(
            params["b_out"], x.dtype)
    gate = lin(x, params["w_gate"], site="w_gate")
    gate = F.silu(gate) if cfg.activation == "silu" else F.gelu(
        gate, approximate="tanh")
    up = lin(x, params["w_up"], site="w_up")
    return lin(gate * up, params["w_out"], site="w_out")


def write_prefill_kv(cache: dict, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> dict:
    """Write one-shot prefill K/V (B, S, G, hd) into a decode cache: slot
    b's positions t < lengths[b] land at index t; the rest are dropped.
    ``pos`` becomes ``lengths``."""
    size = cache["k"].shape[1]
    b, s = k.shape[0], k.shape[1]
    t = torch.arange(s, device=k.device)
    keep = (t[None, :] < lengths[:, None]) & (t[None, :] >= lengths[:, None] - size)
    # dropped positions scatter into one spare row past the cache
    idx = torch.where(keep, t[None, :] % size, size)  # (B, S)

    def scatter(c, new):
        spare = torch.zeros((b, 1) + c.shape[2:], dtype=c.dtype,
                            device=c.device)
        full = torch.cat([c, spare], dim=1)
        ix = idx[:, :, None, None].expand(b, s, *c.shape[2:])
        full.scatter_(1, ix, new.to(c.dtype))
        return full[:, :size]

    return {
        "k": scatter(cache["k"], k),
        "v": scatter(cache["v"], v),
        "pos": lengths.to(torch.int32).expand(cache["pos"].shape).clone(),
    }


def empty_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                   window: Optional[int], dtype, device) -> dict:
    """A layer's cache: ``s_max`` slots, or a ring of min(s_max, window)
    for a sliding-window layer."""
    g, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    size = min(s_max, window) if window is not None else s_max
    return {
        "k": torch.zeros((batch, size, g, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, g, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
