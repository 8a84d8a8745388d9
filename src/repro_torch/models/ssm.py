"""Mamba2 / SSD blocks [arXiv:2405.21060] — a scalar decay per head,
chunked for training, O(1) state for decode.  Used by zamba2.

The counterpart of ``repro.models.ssm`` at tp = 1: ``mamba_init`` /
``_apply`` / ``_decode``, ``_causal_conv`` (depthwise causal conv as k
shifted adds), ``_conv_step``, ``_ssd_chunked``, ``_sharded_rmsnorm``
(at one rank the mean of squares is the local sum over ``d_inner``) and
``mamba_init_state`` (the conv buffers are bf16 whatever the compute
dtype, as the reference's).

``_ssd_chunked`` is the reference's ``lax.scan`` over chunks of
``CHUNK = 64`` tokens in plain PyTorch (the reference's is jnp, not
Pallas): the terms that do not read the carried state are computed for
every chunk at once, and a Python loop over the chunks carries the
state.  Within a chunk the pairwise decay exponents are masked to
``-inf`` above the diagonal BEFORE ``exp``: those differences are
positive and large, and an ``inf`` there would poison the gradient.
The sequence is zero-padded up to a multiple of 64 and cut back after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ninit

CHUNK = 64
HEAD_DIM = 64                          # the SSD head dim


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // HEAD_DIM
    return d_in, HEAD_DIM, nh


def mamba_init(gen: torch.Generator, cfg, dtype=torch.float32,
               device=None) -> dict:
    """One layer's weights, the reference's distributions (``A_log`` the
    log of 1..16 over the heads, ``D`` and the norm scale ones)."""
    d = cfg.d_model
    d_in, _, nh = _dims(cfg)
    ds, k = cfg.ssm_state, cfg.ssm_conv

    def nm(shape, scale=None):
        return ninit(gen, shape, scale=scale, dtype=dtype, device=device)

    return {
        "wz": nm((d, d_in)), "wx": nm((d, d_in)),
        "wB": nm((d, ds)), "wC": nm((d, ds)),
        "wdt": nm((d, nh), 0.02),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                          device=device)).to(dtype),
        "D": torch.ones((nh,), dtype=dtype, device=device),
        "conv_x": nm((k, d_in), 0.5), "conv_B": nm((k, ds), 0.5),
        "conv_C": nm((k, ds), 0.5),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "wo": nm((d_in, d)),
    }


def _sharded_rmsnorm(scale, y: torch.Tensor, d_total: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the channels as the reference's TP form computes it:
    the sum of squares over ``d_total`` (one rank: all of them)."""
    yf = y.float()
    ssq = torch.sum(yf * yf, dim=-1, keepdim=True)
    out = yf * torch.rsqrt(ssq / d_total + eps) * scale.float()
    return out.to(y.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by k shifted adds.  x (b, t, c); w (k, c)."""
    k = w.shape[0]
    out = x * w[-1]
    for j in range(1, k):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[-1 - j]
    return out


def _ssd_chunked(xs, B, C, lw, hl: int, p: int, ds: int) -> torch.Tensor:
    """xs (b, t, hl, p) dt-scaled inputs; B, C (b, t, ds); lw (b, t, hl)
    <= 0; t a multiple of CHUNK.  Returns (b, t, hl, p).  The terms that
    do not read the carried state are computed for all chunks at once;
    the loop over chunks reads and advances the state."""
    b, t = xs.shape[0], xs.shape[1]
    nc = t // CHUNK
    xsc = xs.reshape(b, nc, CHUNK, hl, p)
    Bc, Cc = B.reshape(b, nc, CHUNK, ds), C.reshape(b, nc, CHUNK, ds)
    il = torch.cumsum(lw.reshape(b, nc, CHUNK, hl), dim=2)   # inclusive
    diff = il[:, :, :, None] - il[:, :, None, :]     # (b, nc, t, i, hl)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=xs.device))[:, :, None]
    # mask BEFORE exp: above the diagonal the differences are positive
    # and large, and an inf there would poison the gradient
    diff = torch.where(tri, diff, torch.full_like(diff, -torch.inf))
    dmat = torch.exp(diff)
    cb = torch.einsum("bnts,bnis->bnti", Cc, Bc)     # (b, nc, t, i)
    y = torch.einsum("bntih,bnihp->bnthp", cb[..., None] * dmat, xsc)
    ilc = il[:, :, -1]                               # (b, nc, hl)
    kdec = torch.exp(ilc[:, :, None] - il)           # (b, nc, C, hl)
    add = torch.einsum("bnihp,bnis->bnhps", kdec[..., None] * xsc, Bc)
    dec = torch.exp(ilc)[..., None, None]
    out_dec = torch.exp(il)[..., None]               # (b, nc, C, hl, 1)
    S = torch.zeros((b, hl, p, ds), dtype=xs.dtype, device=xs.device)
    carried = []
    for j in range(nc):
        carried.append(torch.einsum("bhps,bts->bthp", S, Cc[:, j]))
        S = S * dec[:, j] + add[:, j]
    y = y + out_dec * torch.stack(carried, dim=1)
    return y.reshape(b, t, hl, p)


def _proj(prm: dict, xf: torch.Tensor, cd):
    """The input projections: z, the conv inputs of x, B, C, and dt
    (f32, through softplus with its bias)."""
    dt = F.softplus((xf @ prm["wdt"].to(cd)).float()
                    + prm["dt_bias"].float())
    return (xf @ prm["wz"].to(cd), xf @ prm["wx"].to(cd),
            xf @ prm["wB"].to(cd), xf @ prm["wC"].to(cd), dt)


def mamba_apply(prm: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """x (b, t, d) -> (b, t, d)."""
    cd = ctx.compute_dtype
    d_in, p, hl = _dims(cfg)
    ds = cfg.ssm_state
    xf = x.to(cd)
    b, t, _ = xf.shape
    pad = (-t) % CHUNK
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    z, xr, Br, Cr, dt = _proj(prm, xf, cd)
    xx = F.silu(_causal_conv(xr, prm["conv_x"].to(cd)))
    B = F.silu(_causal_conv(Br, prm["conv_B"].to(cd))).float()
    C = F.silu(_causal_conv(Cr, prm["conv_C"].to(cd))).float()
    a = -torch.exp(prm["A_log"].float())               # (hl,) < 0
    lw = a * dt                                         # (b, t, hl)
    tt = xf.shape[1]
    xs = xx.float().reshape(b, tt, hl, p) * dt[..., None]
    y = _ssd_chunked(xs, B, C, lw, hl, p, ds)
    y = y + prm["D"].float()[None, None, :, None] * \
        xx.float().reshape(b, tt, hl, p)
    y = y.reshape(b, tt, hl * p).to(cd)
    y = _sharded_rmsnorm(prm["norm_scale"], y, d_in) * F.silu(z)
    out = y @ prm["wo"].to(cd)
    return out[:, :t] if pad else out


def mamba_init_state(cfg, batch: int, device=None) -> dict:
    """One layer's decode state: the SSM state (b, hl, p, ds) f32 and the
    last k-1 conv inputs of x, B and C in bf16."""
    d_in, p, hl = _dims(cfg)
    ds, k = cfg.ssm_state, cfg.ssm_conv
    bf = torch.bfloat16
    return {
        "S": torch.zeros((batch, hl, p, ds), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros((batch, k - 1, hl * p), dtype=bf,
                              device=device),
        "conv_B": torch.zeros((batch, k - 1, ds), dtype=bf, device=device),
        "conv_C": torch.zeros((batch, k - 1, ds), dtype=bf, device=device),
    }


def _conv_step(xin: torch.Tensor, buf: torch.Tensor, w: torch.Tensor):
    """xin (b, c); buf (b, k-1, c) the past inputs; w (k, c) -> (the conv
    output (b, c), the new buffer)."""
    full = torch.cat([buf.to(xin.dtype), xin[:, None]], dim=1)
    return (full * w[None]).sum(1), full[:, 1:]


def mamba_decode(prm: dict, x: torch.Tensor, state: dict, ctx, cfg):
    """One token: x (b, d); state as ``mamba_init_state``.  Returns
    ``(out (b, d), new_state)`` (the conv buffers cast to bf16)."""
    cd = ctx.compute_dtype
    d_in, p, hl = _dims(cfg)
    xf = x.to(cd)
    b = xf.shape[0]
    z, xraw, Braw, Craw, dt = _proj(prm, xf, cd)            # dt (b, hl)
    xx, cx = _conv_step(xraw, state["conv_x"], prm["conv_x"].to(cd))
    xx = F.silu(xx)
    B, cB = _conv_step(Braw, state["conv_B"], prm["conv_B"].to(cd))
    B = F.silu(B).float()
    C, cC = _conv_step(Craw, state["conv_C"], prm["conv_C"].to(cd))
    C = F.silu(C).float()
    a = -torch.exp(prm["A_log"].float())
    decay = torch.exp(a * dt)                                # (b, hl)
    xsh = xx.float().reshape(b, hl, p) * dt[..., None]
    S = state["S"] * decay[..., None, None] + \
        torch.einsum("bhp,bs->bhps", xsh, B)
    y = torch.einsum("bhps,bs->bhp", S, C) + \
        prm["D"].float()[None, :, None] * xx.float().reshape(b, hl, p)
    y = y.reshape(b, hl * p).to(cd)
    y = _sharded_rmsnorm(prm["norm_scale"], y, d_in) * F.silu(z)
    out = y @ prm["wo"].to(cd)
    bf = torch.bfloat16
    return out, {"S": S, "conv_x": cx.to(bf), "conv_B": cB.to(bf),
                 "conv_C": cC.to(bf)}
