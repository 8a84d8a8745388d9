"""Attention in both TP layouts: the projections, training's self and
cross attention, and the contiguous-cache decode.

The counterparts of ``repro.models.attention``: ``project_qkv`` — q/k/v
projection, then qk-norm, then rope: the single projection convention
the serving engine uses for both its decode step and its prefill window
— ``self_attention`` and ``cross_attention``, which training runs
through the blocked flash attention, ``cross_kv``, ``init_cache``,
``decode_self_attention`` and ``decode_cross_attention``.

At tp > 1 every weight is stacked on the PE axis
(``weights.shard_for_tp``, serving's and training's one layout) and
the activations carry that axis first.  ``cfg.attn_layout(tp)`` picks
the reference's layout:

  head  the query heads divide tp: rank ``t`` holds query heads ``t *
        hpr ..`` (hpr = H / tp) and, when ``n_kv % tp == 0``, KV heads
        ``t * kvpr ..``; otherwise the reference keeps ``wk``/``wv``
        replicated, so every PE holds them whole and slices the one KV
        head its query group reads, ``my_kv = (t * hpr) // group``, in
        the forward (``_kv_weight``).  Training: ``sp_gather`` of the
        (tp, b, t/tp, d) shards, each PE's projections, ONE flash
        launch over every PE's heads (``(tp b, t, H/tp, dh)``: the PE
        axis folded into the batch), ``out_proj`` (row-parallel partial
        sums) and ``sp_scatter``.  Decode: a cache of each PE's KV
        heads ``(tp, b, S, kvpr, dh)`` and a psum after ``wo``.
  ctx   the heads do not divide tp (minitron 24 at 16, gemma 8, whisper
        8): every weight is replicated, every PE keeps all heads for
        its own token shard, K/V are projected locally and all-gathered
        over TP (``tp_comm.all_gather``, whose transpose is a
        reduce-scatter: ``comm.autograd``), and the causal mask puts PE
        ``r``'s queries at ``r * t/tp``: ONE flash launch for every PE,
        each batch row at its PE's offset (``pe_rows`` / ``pe_stride``).
        The output stays sequence-sharded, with no reduction.  Decode:
        the cache is sequence-sharded, ``(tp, b, ceil(S/tp), n_kv,
        dh)``, PE ``r`` holding positions ``r ceil(S/tp) ..``; the slot's
        owner writes it, every PE reads its rows below the current
        length (``decode_attention_partial``, the tail rows past S
        masked) and ``flash_combine`` merges them over ``tp_comm.pmax``
        / ``psum``.

With ``ctx.sp`` off (whisper's encoder) ``sp_gather`` is the identity
and ``sp_scatter`` a psum; in the ctx layout every PE then attends the
whole sequence at offset 0.  A replicated weight's gradient on each PE
is a partial (its heads' or its tokens' share); the train step's TP
completion sums the copies, as the reference's ``tp_fix`` does (its
attention calls no ``grad_sync``).

The cache is bf16 whatever the compute dtype, the reference's default;
``S = min(max_len, swa_window)``, a ring under the sliding window.  The
ctx layout's ring wraps at the window (at tp = 1 the same slots: the
ring is ``min(max_len, window)`` long and a position never reaches
``max_len``); the reference's wraps, and caps the readable length, at
the per-PE row count instead (ROADMAP §C).

Cross attention (whisper's decoder, the vlm's image layers):
``cross_kv`` projects the encoder output or the image embeddings to K/V
(every PE's copy of them at tp > 1), ``cross_attention`` attends a query
sequence to them, non-causal (one flash launch with T != S on the
card), and ``decode_cross_attention`` one token to all S rows, plain f32
as the reference's ``decode_attention``.  No qk-norm and no rope, as
there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.ctx import sp_gather, sp_scatter, tp_of

from .common import apply_rope, pe_mm, rmsnorm, tp_mm
from .flash import (blocked_attention, decode_attention,
                    decode_attention_partial, flash_combine)

__all__ = ["tp_mm", "project_qkv", "out_proj", "self_attention",
           "cross_kv", "cross_attention", "init_cache",
           "decode_self_attention", "decode_cross_attention"]


def _ctx_layout(cfg, tp: int) -> bool:
    return tp > 1 and cfg.attn_layout(tp) == "ctx"


def _kv_weight(w: torch.Tensor, cfg, ctx) -> torch.Tensor:
    """Each PE's K or V projection (tp, d, kvpr dh): its column shard as
    stacked when ``n_kv % tp == 0``; else, from its whole replicated
    copy, the columns of the KV head its query group reads, ``my_kv =
    (rank hpr) // group``, as the reference's ``dynamic_slice``.  In the
    ctx layout every PE projects all KV heads."""
    tp = ctx.tp_size
    if cfg.n_kv % tp == 0 or _ctx_layout(cfg, tp):
        return w
    hpr, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv
    my_kv = (ctx.tp_rank(w.device).long() * hpr) // group
    return w.unflatten(-1, (cfg.n_kv, cfg.head_dim))[
        torch.arange(tp, device=w.device), :, my_kv]


def project_qkv(p: dict, xf: torch.Tensor, pos: torch.Tensor, cfg,
                ctx=None):
    """xf (b, t, d) in the compute dtype; pos (b, t) or (t,) absolute
    positions (at tp > 1 also per PE, (tp, 1, t)).
    Returns q (b, t, H, dh) and k, v (b, t, H_kv, dh).  At tp > 1, xf
    (tp, b, t, d) -> q (tp, b, t, H/tp, dh), k/v (tp, b, t, kvpr, dh)
    from the stacked weights in the head layout, q (tp, b, t, H, dh),
    k/v (tp, b, t, H_kv, dh) in the ctx layout."""
    dh = cfg.head_dim
    if tp_of(ctx) > 1:
        lead = xf.shape[:-1]
        q = tp_mm(xf, p["wq"]).reshape(lead + (-1, dh))
        k = tp_mm(xf, _kv_weight(p["wk"], cfg, ctx)).reshape(lead + (-1, dh))
        v = tp_mm(xf, _kv_weight(p["wv"], cfg, ctx)).reshape(lead + (-1, dh))
    else:
        b, t, _ = xf.shape
        q = (xf @ p["wq"].to(xf.dtype)).reshape(b, t, cfg.n_heads, dh)
        k = (xf @ p["wk"].to(xf.dtype)).reshape(b, t, cfg.n_kv, dh)
        v = (xf @ p["wv"].to(xf.dtype)).reshape(b, t, cfg.n_kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"]["scale"], q)
        k = rmsnorm(p["k_norm"]["scale"], k)
    if cfg.use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def out_proj(o: torch.Tensor, wo: torch.Tensor, ctx=None) -> torch.Tensor:
    """Attention output (..., heads, dh) -> (..., d): ``o @ wo``.  At
    tp > 1, o (tp, ..., hpr, dh) and wo (tp, hpr * dh, d) give each
    rank's partial sum, which the caller psums."""
    o = o.reshape(o.shape[:-2] + (-1,))
    if tp_of(ctx) > 1:
        return tp_mm(o, wo)
    return o @ wo.to(o.dtype)


def _pe_attention(q, k, v, tp: int, **kw):
    """``blocked_attention`` over every PE's heads in ONE call: q (tp, b,
    t, h, dh), k/v (tp, b, s, hkv, dh), the PE axis folded into the
    batch; returns (tp, b, t, h, dh)."""
    o = blocked_attention(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1),
                          **kw)
    return o.unflatten(0, (tp, -1))


def self_attention(p: dict, x: torch.Tensor, ctx, cfg, *, causal=True,
                   window: Optional[int] = None, pos0: int = 0):
    """x (b, t, d) -> (b, t, d): projection at positions ``pos0 + i``,
    blocked attention (``ctx.attn_impl``), output projection.  At tp >
    1 (training), x (tp, b, t/tp, d) sequence shards (the whole (tp, b,
    t, d) with ``ctx.sp`` off) -> the same layout (module docstring)."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    attn = dict(causal=causal, window=window, block_q=ctx.attn_block_q,
                block_kv=ctx.attn_block_kv, impl=ctx.attn_impl)
    if _ctx_layout(cfg, tp):
        xl = x.to(cd)                                     # (tp, b, tl, d)
        tl = xl.shape[2]
        off = tl if ctx.sp else 0                         # PE r at r * off
        pos = pos0 + torch.arange(tl, device=xl.device) + \
            (torch.arange(tp, device=xl.device) * off)[:, None, None]
        q, k, v = project_qkv(p, xl, pos, cfg, ctx)
        if ctx.sp:
            k = ctx.tp_comm.all_gather(k, axis=1, tiled=True)
            v = ctx.tp_comm.all_gather(v, axis=1, tiled=True)
        o = _pe_attention(q, k, v, tp, pe_rows=xl.shape[1],
                      pe_stride=off, **attn)
        return out_proj(o, p["wo"], ctx)                  # stays sharded
    if tp > 1:
        xf = sp_gather(x, ctx).to(cd)                     # (tp, b, t, d)
        pos = pos0 + torch.arange(xf.shape[2], device=xf.device)
        q, k, v = project_qkv(p, xf, pos, cfg, ctx)
        o = _pe_attention(q, k, v, tp, **attn)
        return sp_scatter(out_proj(o, p["wo"], ctx), ctx)
    xf = x.to(cd)
    b, t, _ = xf.shape
    pos = pos0 + torch.arange(t, device=xf.device)
    q, k, v = project_qkv(p, xf, pos, cfg)
    o = blocked_attention(q, k, v, **attn)
    return o.reshape(b, t, -1) @ p["wo"].to(cd)


# ======================================================================
# decode against a contiguous cache
# ======================================================================
def init_cache(cfg, batch: int, max_len: int, device=None, ctx=None) -> dict:
    """The KV cache of one attention layer: ``{"k", "v"}`` zeros of (b, S,
    H_kv, dh) in bf16 (the reference's default, whatever the compute
    dtype), ``S = max_len``, or ``min(max_len, swa_window)`` (a ring)
    under the sliding window.  At tp > 1 every PE's: (tp, b, S, kvpr,
    dh) in the head layout, (tp, b, ceil(S/tp), H_kv, dh) in the ctx
    layout."""
    s = max_len if cfg.swa_window is None else min(max_len, cfg.swa_window)
    tp = tp_of(ctx)
    if _ctx_layout(cfg, tp):
        shape = (tp, batch, -(-s // tp), cfg.n_kv, cfg.head_dim)
    elif tp > 1:
        shape = (tp, batch, s, cfg.kv_per_rank(tp), cfg.head_dim)
    else:
        shape = (batch, s, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def _decode_ctx(p: dict, xf: torch.Tensor, cache: dict, pos: int, ctx, cfg):
    """The ctx layout's step: xf (tp, b, d), every PE's copy; the cache
    sequence-sharded (module docstring)."""
    tp, b, _ = xf.shape
    dev = xf.device
    posv = torch.full((1, b, 1), pos, dtype=torch.long, device=dev)
    q, k, v = project_qkv(p, xf[:, :, None], posv, cfg, ctx)
    win = cfg.swa_window
    slot, cur = (pos % win, min(pos + 1, win)) if win is not None \
        else (pos, pos + 1)
    sl = cache["k"].shape[2]
    owner, at = divmod(slot, sl)          # the one PE that holds the slot
    cache["k"][owner, :, at] = k[owner, :, 0].to(cache["k"].dtype)
    cache["v"][owner, :, at] = v[owner, :, 0].to(cache["v"].dtype)
    gpos = torch.arange(tp * sl, device=dev).reshape(tp, 1, sl)
    valid = (gpos < cur).expand(tp, b, sl).flatten(0, 1)
    acc, m, l = decode_attention_partial(
        q[:, :, 0].flatten(0, 1), cache["k"].flatten(0, 1),
        cache["v"].flatten(0, 1), valid)
    o = flash_combine(*(t.unflatten(0, (tp, b)) for t in (acc, m, l)),
                      {"pmax": ctx.tp_comm.pmax, "psum": ctx.tp_comm.psum})
    return out_proj(o.flatten(-3, -2).to(xf.dtype), p["wo"], ctx)


def decode_self_attention(p: dict, x: torch.Tensor, cache: dict, pos: int,
                          ctx, cfg):
    """One token: x (b, d) at position ``pos`` (an int) -> ((b, d),
    cache).  The token's K/V go to slot ``pos`` (``pos % S`` under the
    sliding window), written IN PLACE into the cache, which is returned;
    the query reads slots ``< min(pos + 1, S)``.  At tp > 1 x (tp, b, d)
    is every PE's copy and so is the output: the head layout's partial
    sums are psummed, the ctx layout's slices combined (module
    docstring)."""
    cd = ctx.compute_dtype
    xf = x.to(cd)
    tp = tp_of(ctx)
    if _ctx_layout(cfg, tp):
        return _decode_ctx(p, xf, cache, pos, ctx, cfg), cache
    s_cache = cache["k"].shape[-3]
    slot = pos % s_cache if cfg.swa_window is not None else pos
    posv = torch.full(xf.shape[:-2] + (xf.shape[-2], 1), pos,
                      dtype=torch.long, device=xf.device)
    q, k, v = project_qkv(p, xf[..., None, :], posv, cfg, ctx)
    cache["k"][..., slot, :, :] = k[..., 0, :, :].to(cache["k"].dtype)
    cache["v"][..., slot, :, :] = v[..., 0, :, :].to(cache["v"].dtype)
    cur = min(pos + 1, s_cache)
    if tp > 1:
        o = decode_attention(q[..., 0, :, :].flatten(0, 1),
                             cache["k"].flatten(0, 1),
                             cache["v"].flatten(0, 1), cur)
        return ctx.tp_comm.psum(
            out_proj(o.unflatten(0, (tp, -1)), p["wo"], ctx)), cache
    o = decode_attention(q[:, 0], cache["k"], cache["v"], cur)
    return o.reshape(xf.shape[0], -1) @ p["wo"].to(cd), cache


# ======================================================================
# cross attention
# ======================================================================
def cross_kv(p: dict, enc: torch.Tensor, ctx, cfg):
    """Encoder output or image embeddings enc (b, S, d) -> (k, v), each
    (b, S, H_kv, dh) in the compute dtype.  At tp > 1, enc (tp, b, S, d)
    (every PE's copy) -> each PE's KV heads (tp, b, S, kvpr, dh), or all
    of them in the ctx layout."""
    cd = ctx.compute_dtype
    ef = enc.to(cd)
    tp = tp_of(ctx)
    kv = [pe_mm(ef, w if tp == 1 else _kv_weight(w, cfg, ctx), tp)
          for w in (p["wk"], p["wv"])]
    return tuple(t.reshape(ef.shape[:-1] + (-1, cfg.head_dim)) for t in kv)


def cross_attention(p: dict, x: torch.Tensor, enc_kv, ctx, cfg):
    """x (b, t, d) attends to ``enc_kv`` = (k, v) from ``cross_kv``, every
    row to all S of them (``blocked_attention(causal=False)``) -> (b, t,
    d).  At tp > 1, x (tp, b, t/tp, d) sequence shards -> the same: the
    head layout gathers the sequence, attends with its heads and
    reduce-scatters the partial sums; the ctx layout attends its shard
    with every head, no collective."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    k, v = enc_kv
    attn = dict(causal=False, block_q=ctx.attn_block_q,
                block_kv=ctx.attn_block_kv, impl=ctx.attn_impl)
    if tp > 1:
        ctxl = _ctx_layout(cfg, tp)
        xf = (x if ctxl else sp_gather(x, ctx)).to(cd)
        q = tp_mm(xf, p["wq"]).reshape(xf.shape[:-1] + (-1, cfg.head_dim))
        out = out_proj(_pe_attention(q, k, v, tp, **attn),
                       p["wo"], ctx)
        return out if ctxl else sp_scatter(out, ctx)
    xf = x.to(cd)
    b, t, _ = xf.shape
    q = (xf @ p["wq"].to(cd)).reshape(b, t, cfg.n_heads, cfg.head_dim)
    o = blocked_attention(q, k, v, **attn)
    return o.reshape(b, t, -1) @ p["wo"].to(cd)


def decode_cross_attention(p: dict, x: torch.Tensor, enc_kv, ctx, cfg):
    """One token x (b, d) against all S rows of ``enc_kv`` -> (b, d); at
    tp > 1 x (tp, b, d), every PE's copy, and the head layout psums its
    partial sums."""
    cd = ctx.compute_dtype
    xf = x.to(cd)
    tp = tp_of(ctx)
    k, v = enc_kv
    q = pe_mm(xf, p["wq"], tp).reshape(xf.shape[:-1] + (-1, cfg.head_dim))
    if tp > 1:
        o = decode_attention(q.flatten(0, 1), k.flatten(0, 1),
                             v.flatten(0, 1), k.shape[-3])
        out = out_proj(o.unflatten(0, (tp, -1)), p["wo"], ctx)
        return out if _ctx_layout(cfg, tp) else ctx.tp_comm.psum(out)
    o = decode_attention(q, k, v, k.shape[1])
    return o.reshape(xf.shape[0], -1) @ p["wo"].to(cd)
