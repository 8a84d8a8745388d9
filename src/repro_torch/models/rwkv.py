"""RWKV6 "Finch" blocks — data-dependent per-channel decay linear
recurrence [arXiv:2404.05892], chunked for training, O(1) state for
decode.

The counterpart of ``repro.models.rwkv``: ``timemix_init`` /
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

At tp > 1 (the stacked layout of ``weights.shard_for_tp``) the padded
heads split over the PEs, ``hl = heads / tp`` each (rwkv6-3b at TP 4: 12,
the 8 ghost heads on PE 3): the receptance, key, value, gate and decay
projections column-parallel per head, ``wo`` and the channel mix's
``wv`` row-parallel, the token-shift mixes and the LoRAs replicated.
The time mix gathers the sequence (``sp_gather``), runs the chunked WKV
over its own heads and reduce-scatters its partial output
(``sp_scatter``); the channel mix shifts on the gathered sequence,
reduce-scatters ``k @ wv`` and takes its receptance on its own shard of
the sequence (rows ``rank * t/tp ..``, ``wr`` replicated).  The decodes
end in a psum, as the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import sp_gather, sp_scatter, tp_of

from .common import ninit, pe_mm, pe_vec

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


def _shift(xf: torch.Tensor) -> torch.Tensor:
    """The token shift: each row's previous row along the sequence (dim
    -2), zeros before the first."""
    return F.pad(xf, (0, 0, 1, 0))[..., :-1, :]


def _mix(p: dict, xf: torch.Tensor, xprev: torch.Tensor, cd, tp: int):
    """RWKV6's data-dependent token-shift mixing of xf (..., t, d) against
    ``xprev`` -> the 5 mixed streams (r, k, v, g, w) and the shift
    ``dx``; at tp > 1 with every PE's replicated weights."""
    dx = xprev - xf
    xxx = xf + dx * pe_vec(p["mu_x"], xf, tp).to(cd)
    z = torch.tanh(pe_mm(xxx, p["lora_w1"], tp))
    z = z.reshape(xf.shape[:-1] + (5, LORA_R))
    w2 = p["lora_w2"].to(cd)
    deltas = (torch.einsum("pbtfr,pfrd->pbtfd", z, w2) if tp > 1 else
              torch.einsum("btfr,frd->btfd", z, w2))
    mixed = xf[..., None, :] + dx[..., None, :] * (
        pe_vec(p["mu5"], xf[..., None, :], tp, 2).to(cd) + deltas)
    return [mixed[..., i, :] for i in range(5)], dx


def _ddlerp(p: dict, xf: torch.Tensor, cd, tp: int = 1):
    """RWKV6's data-dependent token-shift mixing -> the 5 mixed streams
    (r, k, v, g, w) and the shift ``dx``."""
    return _mix(p, xf, _shift(xf), cd, tp)


def _group_norm(y: torch.Tensor, scale, bias, n_heads: int,
                eps: float = 64e-5, tp: int = 1) -> torch.Tensor:
    """Per-head layer norm of y (..., t, n_heads * dh) in f32, then the
    per-channel scale and bias (per PE at tp > 1); cast back to y's
    dtype."""
    da = y.shape[-1]
    yh = y.reshape(y.shape[:-1] + (n_heads, da // n_heads)).float()
    mu = yh.mean(-1, keepdim=True)
    var = torch.square(yh - mu).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    out = yh.reshape(y.shape) * pe_vec(scale, y, tp).float() + \
        pe_vec(bias, y, tp).float()
    return out.to(y.dtype)


def _wkv_chunked(r, k, v, lw, u, hl: int, dh: int) -> torch.Tensor:
    """The chunked RWKV6 recurrence.  r, k, v, lw (b, t, hl, dh) f32 with
    lw the log decay (<= 0), t a multiple of CHUNK; u (hl, dh), or per
    batch row (b, 1, 1, hl, dh).  Returns
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


def _decay_log(p: dict, mw: torch.Tensor, cd, tp: int = 1) -> torch.Tensor:
    """The clamped log-log decay w_raw's log decay ``-exp(min(w_raw,
    W_RAW_MAX))``, f32."""
    w_raw = pe_vec(p["w0"], mw, tp).float() + pe_mm(
        torch.tanh(pe_mm(mw, p["ww1"], tp)).float(), p["ww2"].float(), tp)
    return -torch.exp(torch.clamp(w_raw, max=W_RAW_MAX))


def _heads(cfg, tp: int) -> int:
    """The padded heads a PE holds."""
    return _hp(cfg) // tp


def timemix_apply(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """x (b, t, d) -> (b, t, d); at tp > 1, x (tp, b, t/tp, d) sequence
    shards -> the same (module docstring)."""
    cd = ctx.compute_dtype
    dh = cfg.rwkv_head_dim
    tp = tp_of(ctx)
    hl = _heads(cfg, tp)
    xf = sp_gather(x, ctx).to(cd)
    t = xf.shape[-2]
    pad = (-t) % CHUNK
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    (mr, mk, mv, mg, mw), _ = _ddlerp(p, xf, cd, tp)
    r = pe_mm(mr, p["wr"], tp).float()
    k = pe_mm(mk, p["wk"], tp).float()
    v = pe_mm(mv, p["wv"], tp).float()
    g = F.silu(pe_mm(mg, p["wg"], tp))
    lw = _decay_log(p, mw, cd, tp)
    lead = xf.shape[:-1]                               # ([tp,] b, tt)
    u = p["u"].float().reshape(-1, hl, dh)
    if tp > 1:                      # each PE's u against its batch rows
        u = u.repeat_interleave(lead[1], 0)[:, None, None]
    else:
        u = u[0]
    shape4 = (-1, lead[-1], hl, dh)
    y = _wkv_chunked(r.reshape(shape4), k.reshape(shape4),
                     v.reshape(shape4), lw.reshape(shape4), u, hl, dh)
    y = y.reshape(lead + (hl * dh,)).to(cd)
    y = _group_norm(y, p["gn_scale"], p["gn_bias"], hl, tp=tp)
    out = pe_mm(y * g, p["wo"], tp)
    if pad:
        out = out[..., :t, :]
    return sp_scatter(out, ctx)


def timemix_decode(p: dict, x: torch.Tensor, state: dict, ctx, cfg):
    """One token: x (b, d); state ``{"S": (b, hl, dh, dh) f32, "x_prev":
    (b, d)}``.  Returns ``(out (b, d), {"S": S_new, "x_prev": x})``.  At
    tp > 1 x (tp, b, d), every PE's copy, S (tp, b, hl, dh, dh) its
    heads', and the output is psummed."""
    cd = ctx.compute_dtype
    dh = cfg.rwkv_head_dim
    tp = tp_of(ctx)
    hl = _heads(cfg, tp)
    xf = x.to(cd)[..., None, :]                      # (.., b, 1, d)
    mixed, _ = _mix(p, xf, state["x_prev"].to(cd)[..., None, :], cd, tp)
    mr, mk, mv, mg, mw = (m[..., 0, :] for m in mixed)
    heads = x.shape[:-1] + (hl, dh)
    r = pe_mm(mr, p["wr"], tp).float().reshape(heads)
    k = pe_mm(mk, p["wk"], tp).float().reshape(heads)
    v = pe_mm(mv, p["wv"], tp).float().reshape(heads)
    g = F.silu(pe_mm(mg, p["wg"], tp))
    w = torch.exp(_decay_log(p, mw, cd, tp)).reshape(heads)
    u = pe_vec(p["u"].float().reshape(-1, hl, dh), k, tp, 2)
    if tp == 1:
        u = u[0]
    S = state["S"]
    att = S + u[..., None] * k[..., None] * v[..., None, :]
    y = torch.einsum("...hc,...hce->...he", r, att).reshape(
        x.shape[:-1] + (hl * dh,))
    S_new = S * w[..., None] + k[..., None] * v[..., None, :]
    y = _group_norm(y[..., None, :].to(cd), p["gn_scale"], p["gn_bias"],
                    hl, tp=tp)[..., 0, :]
    out = pe_mm(y * g, p["wo"], tp)
    return (ctx.tp_comm.psum(out) if tp > 1 else out), \
        {"S": S_new, "x_prev": x}


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


def _chanmix(p: dict, xf: torch.Tensor, xprev: torch.Tensor, cd,
             tp: int = 1, reduce=None, mine=None):
    """The channel mix of xf against ``xprev``; at tp > 1 ``reduce``
    completes the row-parallel ``k @ wv`` (psum, or sp_scatter) and
    ``mine`` takes each PE's rows of the receptance's input."""
    dx = xprev - xf
    mk = xf + dx * pe_vec(p["mu_k"], xf, tp).to(cd)
    mr = xf + dx * pe_vec(p["mu_r"], xf, tp).to(cd)
    k = torch.square(F.relu(pe_mm(mk, p["wk"], tp)))
    kv = pe_mm(k, p["wv"], tp)
    if tp > 1:
        kv, mr = reduce(kv), mine(mr)
    return torch.sigmoid(pe_mm(mr, p["wr"], tp)) * kv


def _own_rows(x: torch.Tensor, tl: int) -> torch.Tensor:
    """Each PE's rows ``rank * tl ..`` of its gathered x (tp, b, t, d):
    (tp, b, tl, d)."""
    tp = x.shape[0]
    pe = torch.arange(tp, device=x.device)
    return x.unflatten(2, (tp, tl))[pe, :, pe]


def chanmix_apply(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """x (b, t, d) -> (b, t, d): the token-shifted relu^2 channel mix; at
    tp > 1 x (tp, b, t/tp, d) sequence shards -> the same (module
    docstring)."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    xf = sp_gather(x, ctx).to(cd)
    tl = x.shape[-2]
    return _chanmix(p, xf, _shift(xf), cd, tp,
                    reduce=lambda kv: sp_scatter(kv, ctx),
                    mine=lambda mr: _own_rows(mr, tl) if ctx.sp else mr)


def chanmix_decode(p: dict, x: torch.Tensor, state: dict, ctx, cfg):
    """One token: x (b, d), state ``{"x_prev": (b, d)}``; at tp > 1 x (tp,
    b, d), every PE's copy, ``k @ wv`` psummed."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    return _chanmix(p, x.to(cd), state["x_prev"].to(cd), cd, tp,
                    reduce=ctx.tp_comm.psum if tp > 1 else None,
                    mine=lambda mr: mr), {"x_prev": x}
