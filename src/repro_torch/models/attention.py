"""Attention in the head layout at tensor-parallel size 1.

The counterparts of ``repro.models.attention.project_qkv`` — q/k/v
projection, then qk-norm, then rope: the single projection convention
the serving engine uses for both its decode step and its prefill window
— and of ``self_attention`` (head layout), which training runs through
the blocked flash attention.
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import apply_rope, rmsnorm
from .flash import blocked_attention


def project_qkv(p: dict, xf: torch.Tensor, pos: torch.Tensor, cfg):
    """xf (b, t, d) in the compute dtype; pos (b, t) or (t,) absolute
    positions.
    Returns q (b, t, H, dh) and k, v (b, t, H_kv, dh)."""
    dh = cfg.head_dim
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


def self_attention(p: dict, x: torch.Tensor, ctx, cfg, *, causal=True,
                   window: Optional[int] = None, pos0: int = 0):
    """x (b, t, d) -> (b, t, d): projection at positions ``pos0 + i``,
    blocked attention (``ctx.attn_impl``), output projection."""
    cd = ctx.compute_dtype
    xf = x.to(cd)
    b, t, _ = xf.shape
    pos = pos0 + torch.arange(t, device=xf.device)
    q, k, v = project_qkv(p, xf, pos, cfg)
    o = blocked_attention(q, k, v, causal=causal, window=window,
                          block_q=ctx.attn_block_q,
                          block_kv=ctx.attn_block_kv, impl=ctx.attn_impl)
    return o.reshape(b, t, -1) @ p["wo"].to(cd)
