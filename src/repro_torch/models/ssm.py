"""Mamba2 / SSD blocks [arXiv:2405.21060] — a scalar decay per head,
chunked for training, O(1) state for decode.  Used by zamba2.

The counterpart of ``repro.models.ssm``: ``mamba_init`` /
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

At tp > 1 (the stacked layout of ``weights.shard_for_tp``) ``d_inner``
splits over the PEs by SSD heads (zamba2-7b: 112 heads of 64, 28 a PE
at TP 4): ``wz``, ``wx``, ``wdt``, ``conv_x`` and the per-head vectors
column-parallel, ``wo`` row-parallel, the B / C projections and their
convs replicated.  ``mamba_apply`` gathers the sequence, and its gated
norm sums the squares of its own channels and psums them over TP
(``_sharded_rmsnorm``), then reduce-scatters its partial output;
``mamba_decode`` ends in a psum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import sp_gather, sp_scatter, tp_of

from .common import ninit, pe_mm, pe_vec

CHUNK = 64
HEAD_DIM = 64                          # the SSD head dim


def _dims(cfg, tp: int = 1):
    """(d_inner, the head dim, the heads a PE holds)."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // HEAD_DIM
    return d_in, HEAD_DIM, nh // tp


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


def _sharded_rmsnorm(scale, y: torch.Tensor, d_total: int, ctx=None,
                     eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the channels as the reference's TP form computes it:
    the sum of squares of this PE's channels, psummed over TP, over
    ``d_total`` (one rank: all of them)."""
    tp = tp_of(ctx)
    yf = y.float()
    ssq = torch.sum(yf * yf, dim=-1, keepdim=True)
    if tp > 1:
        ssq = ctx.tp_comm.psum(ssq)
    out = yf * torch.rsqrt(ssq / d_total + eps) * \
        pe_vec(scale, y, tp).float()
    return out.to(y.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 tp: int = 1) -> torch.Tensor:
    """Depthwise causal conv by k shifted adds.  x (..., t, c); w (k, c),
    at tp > 1 each PE's (tp, k, c)."""
    k = w.shape[-2]

    def tap(j):
        return pe_vec(w.select(-2, j), x, tp)

    out = x * tap(-1)
    for j in range(1, k):
        shifted = F.pad(x, (0, 0, j, 0))[..., :-j, :]
        out = out + shifted * tap(k - 1 - j)
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


def _proj(prm: dict, xf: torch.Tensor, cd, tp: int = 1):
    """The input projections: z, the conv inputs of x, B, C, and dt
    (f32, through softplus with its bias)."""
    dt = F.softplus(pe_mm(xf, prm["wdt"], tp).float()
                    + pe_vec(prm["dt_bias"], xf, tp).float())
    return (pe_mm(xf, prm["wz"], tp), pe_mm(xf, prm["wx"], tp),
            pe_mm(xf, prm["wB"], tp), pe_mm(xf, prm["wC"], tp), dt)


def mamba_apply(prm: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """x (b, t, d) -> (b, t, d); at tp > 1, x (tp, b, t/tp, d) sequence
    shards -> the same (module docstring)."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    d_in, p, hl = _dims(cfg, tp)
    ds = cfg.ssm_state
    xf = sp_gather(x, ctx).to(cd)
    t = xf.shape[-2]
    pad = (-t) % CHUNK
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    z, xr, Br, Cr, dt = _proj(prm, xf, cd, tp)
    xx = F.silu(_causal_conv(xr, prm["conv_x"].to(cd), tp))
    B = F.silu(_causal_conv(Br, prm["conv_B"].to(cd), tp)).float()
    C = F.silu(_causal_conv(Cr, prm["conv_C"].to(cd), tp)).float()
    a = -torch.exp(pe_vec(prm["A_log"], dt, tp).float())   # (hl,) < 0
    lw = a * dt                                            # (.., t, hl)
    lead = xf.shape[:-1]                                   # ([tp,] b, tt)
    heads = lead + (hl, p)
    xs = xx.float().reshape(heads) * dt[..., None]
    fold = (-1,) + lead[-1:]            # the PE axis folded into the batch
    y = _ssd_chunked(xs.reshape(fold + (hl, p)), B.reshape(fold + (ds,)),
                     C.reshape(fold + (ds,)), lw.reshape(fold + (hl,)), hl,
                     p, ds).reshape(heads)
    y = y + pe_vec(prm["D"].float(), y[..., 0], tp)[..., None] * \
        xx.float().reshape(heads)
    y = y.reshape(lead + (hl * p,)).to(cd)
    y = _sharded_rmsnorm(prm["norm_scale"], y, d_in, ctx) * F.silu(z)
    out = pe_mm(y, prm["wo"], tp)
    if pad:
        out = out[..., :t, :]
    return sp_scatter(out, ctx)


def mamba_init_state(cfg, batch: int, device=None, ctx=None) -> dict:
    """One layer's decode state: the SSM state (b, hl, p, ds) f32 and the
    last k-1 conv inputs of x, B and C in bf16; at tp > 1 every PE's,
    (tp, b, ...), of its own heads."""
    tp = tp_of(ctx)
    d_in, p, hl = _dims(cfg, tp)
    ds, k = cfg.ssm_state, cfg.ssm_conv
    lead = (tp, batch) if tp > 1 else (batch,)
    bf = torch.bfloat16
    return {
        "S": torch.zeros(lead + (hl, p, ds), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros(lead + (k - 1, hl * p), dtype=bf,
                              device=device),
        "conv_B": torch.zeros(lead + (k - 1, ds), dtype=bf, device=device),
        "conv_C": torch.zeros(lead + (k - 1, ds), dtype=bf, device=device),
    }


def _conv_step(xin: torch.Tensor, buf: torch.Tensor, w: torch.Tensor):
    """xin (..., c); buf (..., k-1, c) the past inputs; w (k, c), or (tp,
    k, c) against xin (tp, b, c) -> (the conv output (..., c), the new
    buffer)."""
    full = torch.cat([buf.to(xin.dtype), xin[..., None, :]], dim=-2)
    return (full * w.unsqueeze(-3)).sum(-2), full[..., 1:, :]


def mamba_decode(prm: dict, x: torch.Tensor, state: dict, ctx, cfg):
    """One token: x (b, d); state as ``mamba_init_state``.  Returns
    ``(out (b, d), new_state)`` (the conv buffers cast to bf16).  At tp >
    1 x (tp, b, d), every PE's copy, and the output is psummed."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    d_in, p, hl = _dims(cfg, tp)
    xf = x.to(cd)
    z, xraw, Braw, Craw, dt = _proj(prm, xf, cd, tp)        # dt (.., hl)
    xx, cx = _conv_step(xraw, state["conv_x"], prm["conv_x"].to(cd))
    xx = F.silu(xx)
    B, cB = _conv_step(Braw, state["conv_B"], prm["conv_B"].to(cd))
    B = F.silu(B).float()
    C, cC = _conv_step(Craw, state["conv_C"], prm["conv_C"].to(cd))
    C = F.silu(C).float()
    a = -torch.exp(pe_vec(prm["A_log"], dt, tp).float())
    decay = torch.exp(a * dt)                                # (.., hl)
    heads = x.shape[:-1] + (hl, p)
    xsh = xx.float().reshape(heads) * dt[..., None]
    S = state["S"] * decay[..., None, None] + \
        torch.einsum("...hp,...s->...hps", xsh, B)
    y = torch.einsum("...hps,...s->...hp", S, C) + \
        pe_vec(prm["D"].float(), dt, tp)[..., None] * \
        xx.float().reshape(heads)
    y = y.reshape(x.shape[:-1] + (hl * p,)).to(cd)
    y = _sharded_rmsnorm(prm["norm_scale"], y, d_in, ctx) * F.silu(z)
    out = pe_mm(y, prm["wo"], tp)
    bf = torch.bfloat16
    return (ctx.tp_comm.psum(out) if tp > 1 else out), {
        "S": S, "conv_x": cx.to(bf), "conv_B": cB.to(bf),
        "conv_C": cC.to(bf)}
