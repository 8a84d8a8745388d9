"""Embedding lookup, LM head, cross-entropy and the greedy/top-k
candidate selection.

The counterparts of ``repro.models.embed`` at tensor-parallel size 1:
the vocab is one shard, so the lookup is a masked gather, the
vocab-parallel cross-entropy's psum/pmax are identities and the
candidate merge across shards has nothing to merge.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def embed_lookup(params: dict, ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """ids (b, t) -> rows (b, t, d) in ``dtype``.  Ids outside the table
    give zero rows, as the reference's masked shard gather does."""
    table = params["table"]
    vloc = table.shape[0]
    ids = ids.long()
    ok = (ids >= 0) & (ids < vloc)
    rows = table[ids.clamp(0, vloc - 1)]
    return torch.where(ok[..., None], rows, torch.zeros_like(rows)).to(dtype)


def lm_head_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(b, d) -> (b, V) logits in ``x``'s dtype."""
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


def lm_head_loss(params: dict, x: torch.Tensor, targets: torch.Tensor, ctx,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """x (b, t, d) final hidden states, targets (b, t) -> mean CE over the
    tokens.  ``vocab_parallel``: logits per chunk of ``ctx.ce_chunk``
    tokens, each chunk recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``),
    so at most one chunk's (tokens x vocab) logits live at a time.
    ``gathered``: the naive full-logits path."""
    table = params["table"]
    vloc = table.shape[0]
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    tg = targets.reshape(b * t).long()
    wt = table.to(ctx.compute_dtype)
    if ctx.ce_mode == "gathered":
        logits = (xf @ wt.T).float()
        mx = logits.amax(-1)
        lse = mx + torch.log(torch.exp(logits - mx[:, None]).sum(-1))
        tl = torch.take_along_dim(logits, tg[:, None], dim=1)[:, 0]
        return (lse - tl).mean()

    def chunk_loss(xc, tc):
        return _chunk_ce((xc @ wt.T).float(), tc, vloc)

    n = xf.shape[0]
    chunk = min(chunk or ctx.ce_chunk, n)
    losses = [checkpoint(chunk_loss, xf[s:s + chunk], tg[s:s + chunk],
                         use_reentrant=False) for s in range(0, n, chunk)]
    return torch.cat(losses).mean()


def tp_sample_candidates(logits: torch.Tensor, k: int):
    """Top-``k`` ``(values, indices)`` along the last axis, sorted
    descending, with equal values in ascending index order — the
    reference's contract (``jax.lax.top_k`` breaks ties toward the lower
    index).  ``torch.topk`` promises no tie order, so this is a stable
    descending sort, cut to ``k``."""
    kk = min(int(k), logits.shape[-1])
    vals, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :kk], order[..., :kk].to(torch.int32)


def tp_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token: the ``k = 1`` case, ties to the lowest index."""
    return tp_sample_candidates(logits, 1)[1][..., 0]
