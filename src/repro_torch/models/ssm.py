"""Mamba2 block with the SSD (state-space duality) chunked algorithm; torch
port of ``repro.models.ssm``.

The sequence runs in chunks (arXiv:2405.21060): inside a chunk the
recurrence in its quadratic dual form, then the chunk states stitched by
a short recurrence over the chunks, and each chunk's carry-in term.
``mamba_forward`` serves the full sequence (forward and prefill, which
also returns the decode cache), ``mamba_step`` one token (O(1) state
(B, H, P, N) in float32 and a ring of the last d_conv - 1 raw conv
inputs).

The in and out projections go through ``lin``: integer PQS dots under
``integer_lin``. The SSD, the conv and the norms are float, as in the
JAX package (the recurrence accumulates decayed float32 state, not an
integer dot). Per-layer vectors arrive in the compute dtype
(``models.model.cast_for_compute``), so ``-exp(a_log)`` is taken in it,
and a bfloat16 vector meets a float32 operand as a float32 product, as
JAX promotes it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, dense_init, lin, rms_norm


def ssm_dims(cfg: ModelConfig) -> dict[str, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    d_xbc = d_inner + 2 * s.n_groups * s.d_state
    return dict(d_inner=d_inner, nheads=nheads, d_xbc=d_xbc,
                d_in_proj=d_inner + d_xbc + nheads)  # z, xBC, dt


def mamba_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    s = cfg.ssm
    dims = ssm_dims(cfg)
    dt = getattr(torch, cfg.param_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    # dt bias such that softplus(dt_bias) spans [dt_min, dt_max]
    u = torch.rand((dims["nheads"],), generator=gen, **f32)
    lo, hi = torch.log(torch.tensor(s.dt_min)), torch.log(
        torch.tensor(s.dt_max))
    dt_init = torch.exp(u * (hi - lo) + lo)
    return {
        "in_proj": dense_init(gen, cfg.d_model, dims["d_in_proj"], dt,
                              device),
        "conv_w": torch.randn((s.d_conv, dims["d_xbc"]), generator=gen,
                              **f32) * (1.0 / s.d_conv) ** 0.5,
        "conv_b": torch.zeros((dims["d_xbc"],), **f32),
        # A = -exp(a_log): mamba2's default A in [-1, -H]
        "a_log": torch.log(torch.arange(1, dims["nheads"] + 1, **f32)),
        "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),
        "d_skip": torch.ones((dims["nheads"],), **f32),
        "out_norm": torch.zeros((dims["d_inner"],), **f32),
        "out_proj": dense_init(gen, dims["d_inner"], cfg.d_model, dt,
                               device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no threshold past which x passes through (``F.softplus`` has
    one)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv_sum(windows, w: torch.Tensor) -> torch.Tensor:
    """sum_i windows[i] (float32) * w[i], added in the order of i."""
    return sum(win.to(torch.float32) * w[i] for i, win in enumerate(windows))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d, xbc (B, L, D), w (K, D): the K shifted
    copies summed in float32 in the order of the taps, then SiLU."""
    k, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = _conv_sum([pad[:, i : i + length] for i in range(k)], w)
    return F.silu(out + b).to(xbc.dtype)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: x (B, L, H, P), dt (B, L, H) float32 after softplus, a
    (H,) negative, bmat / cmat (B, L, G, N), h0 (B, H, P, N) the state
    before the sequence. Returns (y (B, L, H, P), final state (B, H, P,
    N) float32). L must be a multiple of ``chunk``."""
    bsz, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    assert l % chunk == 0, (l, chunk)
    nc, q = l // chunk, chunk
    rep = h // g
    f32 = torch.float32

    bmat = torch.repeat_interleave(bmat, rep, dim=2)  # (B, L, H, N)
    cmat = torch.repeat_interleave(cmat, rep, dim=2)
    xt = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h)
    bc = bmat.reshape(bsz, nc, q, h, n).to(f32)
    cc = cmat.reshape(bsz, nc, q, h, n).to(f32)

    da = dtc * a  # (B, nc, q, H) negative decay increments
    cs = torch.cumsum(da, dim=2)  # within-chunk cumulative decay
    tot = cs[:, :, -1:, :]  # (B, nc, 1, H)

    # intra-chunk (the dual quadratic form): L[i, j] = exp(cs_i - cs_j),
    # i >= j
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B, nc, i, j, H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    att = cb * decay * dtc[:, :, None, :, :]  # dt_j weights column j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", att, xt)

    # chunk states: S_c = sum_j exp(tot - cs_j) dt_j B_j (x) x_j
    decay_to_end = torch.exp(tot - cs)  # (B, nc, q, H)
    wx = xt * (decay_to_end * dtc)[..., None]
    s_chunk = torch.einsum("bcqhp,bcqhn->bchpn", wx, bc)

    # the recurrence over the chunks; each chunk reads the state before it
    chunk_decay = torch.exp(tot[:, :, 0, :])  # (B, nc, H)
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # off-diagonal: the carry-in state's contribution
    cin = cc * torch.exp(cs)[..., None]  # (B, nc, q, H, N)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", cin, prev_states)
    y = (y_diag + y_off).reshape(bsz, l, h, p)
    return y.to(x.dtype), state


def _split(t: torch.Tensor, sizes: list[int]) -> tuple[torch.Tensor, ...]:
    return torch.split(t, sizes, dim=-1)


def mamba_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  h0: Optional[torch.Tensor] = None,
                  lengths: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Any]:
    """Full-sequence Mamba2 block on x (B, L, d_model). Returns (out, the
    final SSD state).

    With ``lengths`` (B,) (one-shot batched prefill) dt is zeroed at t >=
    lengths[b], which makes the recurrence an identity there (decay
    exp(0) = 1, input weight 0): lane b's final state is its state after
    lengths[b] tokens. The return is then (out, {"ssd", "conv"}), a whole
    decode cache: the conv ring holds the last d_conv - 1 raw xBC inputs
    before each lane's end, zeros where the prompt is shorter (a fresh
    ring that shifted in ``lengths`` tokens)."""
    s = cfg.ssm
    dims = ssm_dims(cfg)
    bsz, l, _ = x.shape
    hh, pp, gn = dims["nheads"], s.head_dim, s.n_groups * s.d_state

    zxbcdt = lin(x, params["in_proj"], site="in_proj")
    z, xbc, dtv = _split(zxbcdt, [dims["d_inner"], dims["d_xbc"], hh])
    xbc_raw = xbc  # the pre-conv inputs: what the decode ring stores
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xi, bmat, cmat = _split(xbc, [dims["d_inner"], gn, gn])
    dtv = softplus(dtv.to(torch.float32) + params["dt_bias"])  # (B, L, H)
    if lengths is not None:
        valid = torch.arange(l, device=x.device)[None, :] < lengths[:, None]
        dtv = dtv * valid[:, :, None]
    a = -torch.exp(params["a_log"])  # (H,), in the vector's dtype

    xh = xi.reshape(bsz, l, hh, pp)
    bmat = bmat.reshape(bsz, l, s.n_groups, s.d_state)
    cmat = cmat.reshape(bsz, l, s.n_groups, s.d_state)
    y, final = _ssd_chunked(xh, dtv, a, bmat, cmat, min(s.chunk, l), h0)
    y = y + params["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, l, dims["d_inner"]).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"])
    out = lin(y, params["out_proj"], site="out_proj")
    if lengths is None:
        return out, final
    km1 = s.d_conv - 1
    idx = lengths[:, None].to(torch.int64) - km1 + torch.arange(
        km1, device=x.device)[None, :]  # (B, K - 1)
    took = torch.gather(xbc_raw, 1, torch.clamp_min(idx, 0)[:, :, None]
                        .expand(bsz, km1, xbc_raw.shape[-1]))
    conv = torch.where(idx[:, :, None] >= 0, took, 0).to(xbc_raw.dtype)
    return out, {"ssd": final, "conv": conv}


def empty_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None) -> dict:
    """A layer's decode cache: ``ssd`` (B, H, P, N), always float32, and
    the conv ring (B, d_conv - 1, d_xbc) in ``dtype``."""
    s = cfg.ssm
    dims = ssm_dims(cfg)
    return {
        "ssd": torch.zeros((batch, dims["nheads"], s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, dims["d_xbc"]),
                            dtype=dtype, device=device),
    }


def mamba_step(params: Params, x: torch.Tensor, cache: dict,
               cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One token, x (B, 1, d_model), O(1) in the sequence: the conv over
    the ring and the token, then one step of the recurrence. Returns (out
    (B, 1, d_model), the new cache)."""
    s = cfg.ssm
    dims = ssm_dims(cfg)
    bsz = x.shape[0]
    hh, pp, gn = dims["nheads"], s.head_dim, s.n_groups * s.d_state

    zxbcdt = lin(x[:, 0], params["in_proj"], site="in_proj")  # (B, d_in)
    z, xbc, dtv = _split(zxbcdt, [dims["d_inner"], dims["d_xbc"], hh])
    # the window: the ring's d_conv - 1 inputs, then this one (the ring's
    # dtype and the activations' promote, as in JAX)
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B, K, D)
    conv_out = _conv_sum(win.unbind(1), params["conv_w"])
    xbc_c = F.silu(conv_out + params["conv_b"]).to(x.dtype)
    xi, bmat, cmat = _split(xbc_c, [dims["d_inner"], gn, gn])
    dtv = softplus(dtv.to(torch.float32) + params["dt_bias"])  # (B, H)
    a = -torch.exp(params["a_log"])
    rep = hh // s.n_groups

    xh = xi.reshape(bsz, hh, pp).to(torch.float32)
    bm = torch.repeat_interleave(bmat.reshape(bsz, s.n_groups, s.d_state),
                                 rep, dim=1).to(torch.float32)
    cm = torch.repeat_interleave(cmat.reshape(bsz, s.n_groups, s.d_state),
                                 rep, dim=1).to(torch.float32)
    da = torch.exp(dtv * a)  # (B, H)
    h_new = (da[:, :, None, None] * cache["ssd"]
             + (dtv[:, :, None] * xh)[..., None] * bm[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h_new, cm)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, dims["d_inner"]).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"])
    out = lin(y, params["out_proj"], site="out_proj")[:, None, :]
    return out, {"ssd": h_new, "conv": win[:, 1:, :]}
