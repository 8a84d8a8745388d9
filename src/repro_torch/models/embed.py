"""Embedding lookup, LM head, cross-entropy and the greedy/top-k
candidate selection — the counterparts of ``repro.models.embed``.

At tensor-parallel size 1 the vocab is one shard: the lookup is a
masked gather, the vocab-parallel cross-entropy's psum/pmax are
identities and the candidate merge has nothing to merge.

At tp > 1 (serving, with a ``ctx``) the table is vocab-sharded and
stacked on the PE axis, ``(tp, V/tp, d)`` (``weights.shard_for_tp``),
and activations carry that axis first: the lookup is each shard's
masked gather, then ``ctx.tp_comm.psum``; the head gives each shard's
logits ``(tp, ..., V/tp)``; the candidates are each shard's stable top
``k`` with global indices, merged by ``ctx.tp_comm.top_k_merge`` (ties
to the lowest global index), so every PE holds the same list.

In TP training the lookup's partial rows are not psummed
(``reduce=False``): ``lm._embed_sp`` reduce-scatters them over the
sequence.  The cross-entropy is the reference's chunked vocab-parallel
one: ``sp_gather`` of the final hidden states, each chunk's logits on
each PE's vocab shard, the row max through ``tp_comm.pmax`` (detached,
as the reference stops its gradient), the exp-sums and the target
logits through ``tp_comm.psum``, each chunk recomputed in the backward
(``torch.utils.checkpoint``).  Every PE holds the same per-token losses.
``ce_mode="gathered"`` (the naive path) all-gathers the vocab table over
TP (its transpose reduce-scatters the table's cotangent back to the
shards) and takes the plain full-vocab CE on every PE.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.ctx import sp_gather, tp_of


def _ranks(ctx, like: torch.Tensor) -> torch.Tensor:
    """(tp, 1, ..., 1) ranks broadcasting against ``like`` (tp, ...)."""
    r = ctx.tp_rank(like.device).long()
    return r.view((-1,) + (1,) * (like.dim() - 1))


def embed_lookup(params: dict, ids: torch.Tensor,
                 dtype: torch.dtype, ctx=None,
                 reduce: bool = True) -> torch.Tensor:
    """ids (b, t) -> rows (b, t, d) in ``dtype``.  Ids outside the table
    give zero rows, as the reference's masked shard gather does.  At
    tp > 1 the table is ``(tp, V/tp, d)``: each shard gathers the ids in
    its range, and the psum over the PE axis gives every PE the rows,
    ``(tp, b, t, d)``; ``reduce=False`` returns the shards' partial rows
    unreduced."""
    table = params["table"]
    if tp_of(ctx) > 1:
        tp, vloc, d = table.shape
        loc = ids.long()[None] - _ranks(ctx, ids[None]) * vloc
        ok = (loc >= 0) & (loc < vloc)
        flat = loc.clamp(0, vloc - 1) + _ranks(ctx, loc) * vloc
        rows = table.reshape(tp * vloc, d)[flat]
        rows = torch.where(ok[..., None], rows,
                           torch.zeros_like(rows)).to(dtype)
        return ctx.tp_comm.psum(rows) if reduce else rows
    vloc = table.shape[0]
    ids = ids.long()
    ok = (ids >= 0) & (ids < vloc)
    rows = table[ids.clamp(0, vloc - 1)]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows)).to(dtype)


def lm_head_logits(params: dict, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """(b, d) -> (b, V) logits in ``x``'s dtype.  At tp > 1, x (tp, ...,
    d) -> each shard's logits (tp, ..., V/tp)."""
    if tp_of(ctx) > 1:
        t = params["table"]
        out = torch.bmm(x.reshape(t.shape[0], -1, t.shape[2]),
                        t.to(x.dtype).transpose(1, 2))
        return out.reshape(x.shape[:-1] + (t.shape[1],))
    return x @ params["table"].to(x.dtype).T


def _chunk_ce(logits: torch.Tensor, targets: torch.Tensor,
              vloc: int) -> torch.Tensor:
    """Per-token CE over one chunk, logits (n, vloc) f32 — the reference's
    vocab-parallel ``_chunk_ce`` at one shard.  The stability shift is
    not a function of x for the gradient (detached, as its
    ``stop_gradient``)."""
    mx = logits.detach().amax(-1)
    ssum = torch.exp(logits - mx[:, None]).sum(-1)
    tl = torch.take_along_dim(logits, targets.clamp(0, vloc - 1)[:, None],
                              dim=1)[:, 0]
    ok = (targets >= 0) & (targets < vloc)
    tl = torch.where(ok, tl, torch.zeros_like(tl))
    return -(tl - mx - torch.log(ssum.clamp_min(1e-30)))


def _chunk_ce_tp(logits: torch.Tensor, targets: torch.Tensor, vloc: int,
                 ctx) -> torch.Tensor:
    """The reference's ``_chunk_ce`` on every PE's shard: logits (tp, n,
    V/tp) f32, targets (n,) -> per-token CE (tp, n), the same on every
    PE."""
    mx = ctx.tp_comm.pmax(logits.detach().amax(-1))
    ssum = ctx.tp_comm.psum(torch.exp(logits - mx[..., None]).sum(-1))
    loc = targets[None] - _ranks(ctx, logits)[..., 0] * vloc
    ok = (loc >= 0) & (loc < vloc)
    tl = torch.take_along_dim(logits, loc.clamp(0, vloc - 1)[..., None],
                              dim=-1)[..., 0]
    tl = ctx.tp_comm.psum(torch.where(ok, tl, torch.zeros_like(tl)))
    return -(tl - mx - torch.log(ssum.clamp_min(1e-30)))


def _gathered_ce(xf: torch.Tensor, wt: torch.Tensor,
                 tg: torch.Tensor) -> torch.Tensor:
    """The naive CE over the full vocab: xf (..., n, d), wt (..., V, d),
    targets (n,) -> the mean over the n tokens (...)."""
    logits = (xf @ wt.transpose(-1, -2)).float()
    mx = logits.amax(-1)
    lse = mx + torch.log(torch.exp(logits - mx[..., None]).sum(-1))
    tl = torch.take_along_dim(logits, tg.expand(logits.shape[:-1])[..., None],
                              dim=-1)[..., 0]
    return (lse - tl).mean(-1)


def _lm_head_loss_tp(table, x, targets, ctx, chunk) -> torch.Tensor:
    """``lm_head_loss`` at tp > 1: table (tp, V/tp, d), x (tp, b, t/tp, d)
    sequence shards -> (tp,) losses, the chunked vocab-parallel CE or the
    gathered one (module docstring)."""
    tp, vloc, d = table.shape
    xf = sp_gather(x, ctx).reshape(tp, -1, d)            # (tp, b t, d)
    tg = targets.reshape(-1).long()
    if ctx.ce_mode == "gathered":
        full = ctx.tp_comm.all_gather(table, axis=0, tiled=True)
        return _gathered_ce(xf, full.to(ctx.compute_dtype), tg)
    wt = table.to(ctx.compute_dtype).transpose(1, 2)

    def chunk_loss(xc, tc):
        return _chunk_ce_tp(torch.bmm(xc, wt).float(), tc, vloc, ctx)

    n = xf.shape[1]
    chunk = min(chunk or ctx.ce_chunk, n)
    losses = [checkpoint(chunk_loss, xf[:, s:s + chunk], tg[s:s + chunk],
                         use_reentrant=False) for s in range(0, n, chunk)]
    return torch.cat(losses, dim=1).mean(-1)


def lm_head_loss(params: dict, x: torch.Tensor, targets: torch.Tensor, ctx,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """x (b, t, d) final hidden states, targets (b, t) -> mean CE over the
    tokens.  ``vocab_parallel``: logits per chunk of ``ctx.ce_chunk``
    tokens, each chunk recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``),
    so at most one chunk's (tokens x vocab) logits live at a time.
    ``gathered``: the naive full-logits path.  At tp > 1, x
    (tp, b, t/tp, d) -> every PE's loss, (tp,) (module docstring)."""
    table = params["table"]
    if tp_of(ctx) > 1:
        return _lm_head_loss_tp(table, x, targets, ctx, chunk)
    vloc = table.shape[0]
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    tg = targets.reshape(b * t).long()
    wt = table.to(ctx.compute_dtype)
    if ctx.ce_mode == "gathered":
        return _gathered_ce(xf, wt, tg)

    def chunk_loss(xc, tc):
        return _chunk_ce((xc @ wt.T).float(), tc, vloc)

    n = xf.shape[0]
    chunk = min(chunk or ctx.ce_chunk, n)
    losses = [checkpoint(chunk_loss, xf[s:s + chunk], tg[s:s + chunk],
                         use_reentrant=False) for s in range(0, n, chunk)]
    return torch.cat(losses).mean()


def tp_sample_candidates(logits: torch.Tensor, k: int, ctx=None):
    """Top-``k`` ``(values, indices)`` along the last axis, sorted
    descending, with equal values in ascending index order — the
    reference's contract (``jax.lax.top_k`` breaks ties toward the lower
    index).  ``torch.topk`` promises no tie order, so this is a stable
    descending sort, cut to ``k``.

    At tp > 1, ``logits`` (tp, ..., V/tp) are the shards: phase 1 takes
    each shard's top ``min(k, V/tp)`` with its GLOBAL index (``rank *
    V/tp`` added), phase 2 merges the lists through
    ``ctx.tp_comm.top_k_merge`` (lowest global index wins a tie).
    Returns (tp, ..., k) lists, the same on every PE, values in f32."""
    kk = min(int(k), logits.shape[-1])
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, order = vals[..., :kk], order[..., :kk].to(torch.int32)
    if tp_of(ctx) == 1:
        return vals, order
    gidx = order + (_ranks(ctx, order) * logits.shape[-1]).to(torch.int32)
    return ctx.tp_comm.top_k_merge(vals, gidx, kk)


def tp_argmax(logits: torch.Tensor, ctx=None) -> torch.Tensor:
    """Greedy token: the ``k = 1`` case, ties to the lowest (global)
    index."""
    return tp_sample_candidates(logits, 1, ctx)[1][..., 0]
