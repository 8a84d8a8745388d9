"""RWKV6 "Finch" blocks — data-dependent per-channel decay linear
recurrence [arXiv:2404.05892], chunked for training, O(1) state for
decode.

The counterpart of ``repro.models.rwkv`` at tp = 1: ``timemix_init`` /
``_apply`` / ``_decode``, ``chanmix_init`` / ``_apply`` / ``_decode``,
``_ddlerp`` (the data-dependent token shift), ``_group_norm`` (eps 64e-5
over the padded head count) and ``_wkv_chunked``.  Heads are padded
(rwkv6-3b: 40 -> 48) as the reference pads them for TP; the ghost heads'
weights, their ``wo`` rows included, are drawn like any other, as the
reference's init draws them.

``_wkv_chunked`` is the reference's ``lax.scan`` over chunks of
``CHUNK = 16`` tokens in plain PyTorch (the reference's is jnp, not
Pallas): the terms that do not read the carried state are computed for
every chunk at once, and a Python loop over the chunks carries the
state (a few launches a chunk).  Within a chunk the products of the
per-channel decays are taken in log space about the chunk's midpoint,
and the log-log decay is clamped at ``W_RAW_MAX = 1.2`` (a step's decay
stays >= e^-3.3), so the half-chunk exponents stay in f32 range.  The
sequence is zero-padded up to a multiple of 16 and cut back after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ninit

LORA_R = 32
DECAY_LORA_R = 64
W_RAW_MAX = 1.2
CHUNK = 16


def _hp(cfg) -> int:
    return cfg.rwkv_padded_heads or cfg.n_heads


def timemix_init(gen: torch.Generator, cfg, dtype=torch.float32,
                 device=None) -> dict:
    """One layer's time-mix weights, the reference's distributions."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    da = _hp(cfg) * dh

    def nm(shape, scale=None):
        return ninit(gen, shape, scale=scale, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "mu_x": zeros(d),
        "mu5": zeros(5, d),
        "lora_w1": nm((d, 5 * LORA_R), 0.02),
        "lora_w2": nm((5, LORA_R, d), 0.02),
        "wr": nm((d, da)), "wk": nm((d, da)), "wv": nm((d, da)),
        "wg": nm((d, da)),
        "w0": torch.linspace(-6.0, 0.0, da, device=device).to(dtype),
        "ww1": nm((d, DECAY_LORA_R), 0.02),
        "ww2": nm((DECAY_LORA_R, da), 0.02),
        "u": nm((da,), 1.0),
        "gn_scale": torch.ones((da,), dtype=dtype, device=device),
        "gn_bias": zeros(da),
        "wo": nm((da, d)),
    }


def _ddlerp(p: dict, xf: torch.Tensor, cd):
    """RWKV6's data-dependent token-shift mixing -> the 5 mixed streams
    (r, k, v, g, w) and the shift ``dx``."""
    xprev = F.pad(xf, (0, 0, 1, 0))[:, :-1]
    dx = xprev - xf
    xxx = xf + dx * p["mu_x"].to(cd)
    z = torch.tanh(xxx @ p["lora_w1"].to(cd))
    b, t, _ = xf.shape
    z = z.reshape(b, t, 5, LORA_R)
    deltas = torch.einsum("btfr,frd->btfd", z, p["lora_w2"].to(cd))
    mixed = xf[:, :, None] + dx[:, :, None] * (
        p["mu5"].to(cd)[None, None] + deltas)
    return [mixed[:, :, i] for i in range(5)], dx


def _group_norm(y: torch.Tensor, scale, bias, n_heads: int,
                eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm of y (b, t, n_heads * dh) in f32, then the
    per-channel scale and bias; cast back to y's dtype."""
    b, t, da = y.shape
    yh = y.reshape(b, t, n_heads, da // n_heads).float()
    mu = yh.mean(-1, keepdim=True)
    var = torch.square(yh - mu).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    out = yh.reshape(b, t, da) * scale.float() + bias.float()
    return out.to(y.dtype)


def _wkv_chunked(r, k, v, lw, u, hl: int, dh: int) -> torch.Tensor:
    """The chunked RWKV6 recurrence.  r, k, v, lw (b, t, hl, dh) f32 with
    lw the log decay (<= 0), t a multiple of CHUNK; u (hl, dh).  Returns
    (b, t, hl, dh).  Everything but the carried state is computed for
    all chunks at once; the loop over chunks only reads and advances the
    state (the reference's scan body, term for term)."""
    b, t = r.shape[0], r.shape[1]
    nc = t // CHUNK
    rc, kc, vc, lwc = (a.reshape(b, nc, CHUNK, hl, dh)
                       for a in (r, k, v, lw))
    el = torch.cumsum(lwc, dim=2) - lwc              # exclusive cumsum
    elc = el[:, :, -1] + lwc[:, :, -1]               # each chunk's decay
    mid = el[:, :, CHUNK // 2][:, :, None]           # normalizer
    a_t = torch.exp(el - mid) * rc
    b_i = torch.exp(mid - el - lwc) * kc
    s = torch.einsum("bnthc,bnihc->bnhti", a_t, b_i)     # (b, nc, hl, C, C)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    s = torch.where(tri, s, torch.zeros_like(s))
    intra = torch.einsum("bnhti,bnihc->bnthc", s, vc)
    bonus = (rc * u * kc).sum(-1, keepdim=True) * vc
    q_in = torch.exp(el) * rc
    kdec = torch.exp(elc[:, :, None] - el - lwc) * kc
    add = torch.einsum("bnihc,bnihe->bnhce", kdec, vc)   # each chunk's S
    dec = torch.exp(elc)[..., None]
    S = torch.zeros((b, hl, dh, dh), dtype=r.dtype, device=r.device)
    inter = []
    for j in range(nc):
        inter.append(torch.einsum("bthc,bhce->bthe", q_in[:, j], S))
        S = S * dec[:, j] + add[:, j]
    y = intra + bonus + torch.stack(inter, dim=1)
    return y.reshape(b, t, hl, dh)


def _decay_log(p: dict, mw: torch.Tensor, cd) -> torch.Tensor:
    """The clamped log-log decay w_raw's log decay ``-exp(min(w_raw,
    W_RAW_MAX))``, f32."""
    w_raw = p["w0"].float() + \
        torch.tanh(mw @ p["ww1"].to(cd)).float() @ p["ww2"].float()
    return -torch.exp(torch.clamp(w_raw, max=W_RAW_MAX))


def timemix_apply(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """x (b, t, d) -> (b, t, d)."""
    cd = ctx.compute_dtype
    dh = cfg.rwkv_head_dim
    hl = _hp(cfg)
    xf = x.to(cd)
    b, t, _ = xf.shape
    pad = (-t) % CHUNK
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    (mr, mk, mv, mg, mw), _ = _ddlerp(p, xf, cd)
    r = (mr @ p["wr"].to(cd)).float()
    k = (mk @ p["wk"].to(cd)).float()
    v = (mv @ p["wv"].to(cd)).float()
    g = F.silu(mg @ p["wg"].to(cd))
    lw = _decay_log(p, mw, cd)
    tt = xf.shape[1]
    shape4 = (b, tt, hl, dh)
    y = _wkv_chunked(r.reshape(shape4), k.reshape(shape4),
                     v.reshape(shape4), lw.reshape(shape4),
                     p["u"].float().reshape(hl, dh), hl, dh)
    y = y.reshape(b, tt, hl * dh).to(cd)
    y = _group_norm(y, p["gn_scale"], p["gn_bias"], hl)
    out = (y * g) @ p["wo"].to(cd)
    return out[:, :t] if pad else out


def timemix_decode(p: dict, x: torch.Tensor, state: dict, ctx, cfg):
    """One token: x (b, d); state ``{"S": (b, hl, dh, dh) f32, "x_prev":
    (b, d)}``.  Returns ``(out (b, d), {"S": S_new, "x_prev": x})``."""
    cd = ctx.compute_dtype
    dh = cfg.rwkv_head_dim
    hl = _hp(cfg)
    xf = x.to(cd)[:, None]                           # (b, 1, d)
    xprev = state["x_prev"].to(cd)[:, None]
    dx = xprev - xf
    xxx = xf + dx * p["mu_x"].to(cd)
    z = torch.tanh(xxx @ p["lora_w1"].to(cd)).reshape(-1, 1, 5, LORA_R)
    deltas = torch.einsum("btfr,frd->btfd", z, p["lora_w2"].to(cd))
    mixed = xf[:, :, None] + dx[:, :, None] * (
        p["mu5"].to(cd)[None, None] + deltas)
    mr, mk, mv, mg, mw = (mixed[:, 0, i] for i in range(5))
    b = x.shape[0]
    r = (mr @ p["wr"].to(cd)).float().reshape(b, hl, dh)
    k = (mk @ p["wk"].to(cd)).float().reshape(b, hl, dh)
    v = (mv @ p["wv"].to(cd)).float().reshape(b, hl, dh)
    g = F.silu(mg @ p["wg"].to(cd))
    w = torch.exp(_decay_log(p, mw, cd)).reshape(b, hl, dh)
    u = p["u"].float().reshape(hl, dh)
    S = state["S"]
    att = S + u[None, :, :, None] * k[..., None] * v[:, :, None, :]
    y = torch.einsum("bhc,bhce->bhe", r, att).reshape(b, hl * dh)
    S_new = S * w[..., None] + k[..., None] * v[:, :, None, :]
    y = _group_norm(y[:, None].to(cd), p["gn_scale"], p["gn_bias"],
                    hl)[:, 0]
    out = (y * g) @ p["wo"].to(cd)
    return out, {"S": S_new, "x_prev": x}


# ----------------------------------------------------------------------
# channel-mix
# ----------------------------------------------------------------------
def chanmix_init(gen: torch.Generator, cfg, dtype=torch.float32,
                 device=None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff

    def nm(shape):
        return ninit(gen, shape, dtype=dtype, device=device)

    return {"mu_k": torch.zeros((d,), dtype=dtype, device=device),
            "mu_r": torch.zeros((d,), dtype=dtype, device=device),
            "wk": nm((d, ff)), "wv": nm((ff, d)), "wr": nm((d, d))}


def _chanmix(p: dict, xf: torch.Tensor, xprev: torch.Tensor, cd):
    dx = xprev - xf
    mk = xf + dx * p["mu_k"].to(cd)
    mr = xf + dx * p["mu_r"].to(cd)
    k = torch.square(F.relu(mk @ p["wk"].to(cd)))
    kv = k @ p["wv"].to(cd)
    return torch.sigmoid(mr @ p["wr"].to(cd)) * kv


def chanmix_apply(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """x (b, t, d) -> (b, t, d): the token-shifted relu^2 channel mix."""
    cd = ctx.compute_dtype
    xf = x.to(cd)
    return _chanmix(p, xf, F.pad(xf, (0, 0, 1, 0))[:, :-1], cd)


def chanmix_decode(p: dict, x: torch.Tensor, state: dict, ctx, cfg):
    """One token: x (b, d), state ``{"x_prev": (b, d)}``."""
    cd = ctx.compute_dtype
    return _chanmix(p, x.to(cd), state["x_prev"].to(cd), cd), {"x_prev": x}
