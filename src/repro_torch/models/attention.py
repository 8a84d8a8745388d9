"""Attention in the head layout.

The counterparts of ``repro.models.attention.project_qkv`` — q/k/v
projection, then qk-norm, then rope: the single projection convention
the serving engine uses for both its decode step and its prefill window
— and of ``self_attention`` (head layout), which training runs
through the blocked flash attention.

At tp > 1 the projections are stacked on the PE axis
(``weights.shard_for_tp``, serving's and training's one layout): rank
``t`` holds query heads ``t * hpr ..`` (hpr = H / tp) and, when ``n_kv %
tp == 0``, KV heads ``t * kvpr ..``; otherwise the reference keeps
``wk``/``wv`` replicated, so every PE holds them whole and slices the
one KV head its query group reads, ``my_kv = (t * hpr) // group``, in
the forward (``_kv_weight``).  ``tp_mm`` is the per-rank product, one
batched matmul over the PE axis, and ``out_proj`` the row-parallel
output projection, partial sums the caller reduces.

``self_attention`` at tp > 1 (training) is the reference's head layout
under sequence parallelism: ``sp_gather`` of the (tp, b, t/tp, d)
shards, each PE's projections, qk-norm and rope, ONE flash launch over
every PE's heads (``(tp b, t, H/tp, dh)``: the PE axis folded into the
batch), ``out_proj`` and ``sp_scatter`` of its partial sums.  A
replicated ``wk``/``wv``'s gradient lands in the sliced head's columns
of each PE's copy; the train step's TP completion sums the copies, as
the reference's ``tp_fix`` does (its attention calls no
``grad_sync``).  The ctx layout (heads not dividing tp) raises: ROADMAP
A10.

The contiguous-cache decode path (``init_cache``,
``decode_self_attention``) runs at tp = 1, the reference's head
layout: a bf16 cache ``(b, S, H_kv, dh)`` whatever the compute dtype,
``S = min(max_len, swa_window)``, a ring under the sliding window.  The
reference's ctx layout (heads not dividing tp, the cache sequence-
sharded over the ranks and merged by ``flash_combine``) exists only at
tp > 1, which ``models.lm``'s decode entry points refuse: it comes with
ROADMAP A10's next slice.

Cross attention (whisper's decoder, the vlm's image layers) at tp = 1,
the reference's head layout: ``cross_kv`` projects the encoder output
or the image embeddings to K/V ``(b, S, H_kv, dh)``, ``cross_attention``
attends a query sequence to them, non-causal (one flash launch with T
!= S on the card), and ``decode_cross_attention`` one token to all S
rows, plain f32 as the reference's ``decode_attention``.  No qk-norm and
no rope, as there.  At tp > 1 they raise (TP training, ROADMAP A10).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.parallel.ctx import A10_TP, sp_gather, sp_scatter, tp_of

from .common import apply_rope, rmsnorm
from .flash import blocked_attention, decode_attention


def tp_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-rank product: x (tp, ..., d) @ w (tp, d, n) -> (tp, ..., n), one
    batched matmul (the weights are never broadcast against ``x``)."""
    tp, d, n = w.shape
    out = torch.bmm(x.reshape(tp, -1, d), w.to(x.dtype))
    return out.reshape(x.shape[:-1] + (n,))


def _kv_weight(w: torch.Tensor, cfg, ctx) -> torch.Tensor:
    """Each PE's K or V projection (tp, d, kvpr dh): its column shard as
    stacked when ``n_kv % tp == 0``; else, from its whole replicated
    copy, the columns of the KV head its query group reads, ``my_kv =
    (rank hpr) // group``, as the reference's ``dynamic_slice``."""
    tp = ctx.tp_size
    if cfg.n_kv % tp == 0:
        return w
    hpr, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv
    my_kv = (ctx.tp_rank(w.device).long() * hpr) // group
    return w.unflatten(-1, (cfg.n_kv, cfg.head_dim))[
        torch.arange(tp, device=w.device), :, my_kv]


def project_qkv(p: dict, xf: torch.Tensor, pos: torch.Tensor, cfg,
                ctx=None):
    """xf (b, t, d) in the compute dtype; pos (b, t) or (t,) absolute
    positions.
    Returns q (b, t, H, dh) and k, v (b, t, H_kv, dh).  At tp > 1, xf
    (tp, b, t, d) -> q (tp, b, t, H/tp, dh), k/v (tp, b, t, kvpr, dh)
    from the stacked weights."""
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


def self_attention(p: dict, x: torch.Tensor, ctx, cfg, *, causal=True,
                   window: Optional[int] = None, pos0: int = 0):
    """x (b, t, d) -> (b, t, d): projection at positions ``pos0 + i``,
    blocked attention (``ctx.attn_impl``), output projection.  At tp >
    1 (training), x (tp, b, t/tp, d) sequence shards -> the same layout
    (module docstring)."""
    cd = ctx.compute_dtype
    tp = tp_of(ctx)
    if tp > 1:
        if cfg.attn_layout(tp) != "head":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_heads} heads at tp={tp} take the ctx "
                f"attention layout: {A10_TP}")
        xf = sp_gather(x, ctx).to(cd)                     # (tp, b, t, d)
        _, b, t, _ = xf.shape
        pos = pos0 + torch.arange(t, device=xf.device)
        q, k, v = project_qkv(p, xf, pos, cfg, ctx)
        o = blocked_attention(q.flatten(0, 1), k.flatten(0, 1),
                              v.flatten(0, 1), causal=causal, window=window,
                              block_q=ctx.attn_block_q,
                              block_kv=ctx.attn_block_kv, impl=ctx.attn_impl)
        return sp_scatter(out_proj(o.unflatten(0, (tp, b)), p["wo"], ctx),
                          ctx)
    xf = x.to(cd)
    b, t, _ = xf.shape
    pos = pos0 + torch.arange(t, device=xf.device)
    q, k, v = project_qkv(p, xf, pos, cfg)
    o = blocked_attention(q, k, v, causal=causal, window=window,
                          block_q=ctx.attn_block_q,
                          block_kv=ctx.attn_block_kv, impl=ctx.attn_impl)
    return o.reshape(b, t, -1) @ p["wo"].to(cd)


# ======================================================================
# decode against a contiguous cache (tp = 1)
# ======================================================================
def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """The KV cache of one attention layer at tp = 1: ``{"k", "v"}`` zeros
    of (b, S, H_kv, dh) in bf16 (the reference's default, whatever the
    compute dtype), ``S = max_len``, or ``min(max_len, swa_window)`` (a
    ring) under the sliding window."""
    s = max_len if cfg.swa_window is None else min(max_len, cfg.swa_window)
    shape = (batch, s, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def decode_self_attention(p: dict, x: torch.Tensor, cache: dict, pos: int,
                          ctx, cfg):
    """One token at tp = 1: x (b, d) at position ``pos`` (an int) -> ((b,
    d), cache).  The token's K/V go to slot ``pos`` (``pos % S`` under the
    sliding window), written IN PLACE into the cache, which is returned;
    the query reads slots ``< min(pos + 1, S)``."""
    cd = ctx.compute_dtype
    xf = x.to(cd)
    b = xf.shape[0]
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache if cfg.swa_window is not None else pos
    posv = torch.full((b, 1), pos, dtype=torch.long, device=xf.device)
    q, k, v = project_qkv(p, xf[:, None], posv, cfg)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q[:, 0], cache["k"], cache["v"],
                         min(pos + 1, s_cache))
    return o.reshape(b, -1) @ p["wo"].to(cd), cache


# ======================================================================
# cross attention (tp = 1)
# ======================================================================
def _check_cross_tp(ctx) -> None:
    if tp_of(ctx) > 1:
        raise NotImplementedError(
            f"cross attention at tp={ctx.tp_size} arrives with TP training, "
            f"ROADMAP A10")


def cross_kv(p: dict, enc: torch.Tensor, ctx, cfg):
    """Encoder output or image embeddings enc (b, S, d) -> (k, v), each
    (b, S, H_kv, dh) in the compute dtype."""
    _check_cross_tp(ctx)
    cd = ctx.compute_dtype
    ef = enc.to(cd)
    b, s, _ = ef.shape
    k = (ef @ p["wk"].to(cd)).reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = (ef @ p["wv"].to(cd)).reshape(b, s, cfg.n_kv, cfg.head_dim)
    return k, v


def cross_attention(p: dict, x: torch.Tensor, enc_kv, ctx, cfg):
    """x (b, t, d) attends to ``enc_kv`` = (k, v) from ``cross_kv``, every
    row to all S of them (``blocked_attention(causal=False)``) -> (b, t,
    d)."""
    _check_cross_tp(ctx)
    cd = ctx.compute_dtype
    xf = x.to(cd)
    b, t, _ = xf.shape
    k, v = enc_kv
    q = (xf @ p["wq"].to(cd)).reshape(b, t, cfg.n_heads, cfg.head_dim)
    o = blocked_attention(q, k, v, causal=False, block_q=ctx.attn_block_q,
                          block_kv=ctx.attn_block_kv, impl=ctx.attn_impl)
    return o.reshape(b, t, -1) @ p["wo"].to(cd)


def decode_cross_attention(p: dict, x: torch.Tensor, enc_kv, ctx, cfg):
    """One token x (b, d) against all S rows of ``enc_kv`` -> (b, d)."""
    _check_cross_tp(ctx)
    cd = ctx.compute_dtype
    xf = x.to(cd)
    b = xf.shape[0]
    k, v = enc_kv
    q = (xf @ p["wq"].to(cd)).reshape(b, cfg.n_heads, cfg.head_dim)
    o = decode_attention(q, k, v, k.shape[1])
    return o.reshape(b, -1) @ p["wo"].to(cd)
