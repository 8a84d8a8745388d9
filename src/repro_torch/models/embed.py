"""Embedding lookup, LM head and the greedy/top-k candidate selection.

The counterparts of ``repro.models.embed`` at tensor-parallel size 1:
the vocab is one shard, so the lookup is a masked gather and the
candidate merge across shards has nothing to merge.
"""
from __future__ import annotations

import torch


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
