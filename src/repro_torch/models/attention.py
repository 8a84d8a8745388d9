"""Attention projections in the head layout at tensor-parallel size 1.

The counterpart of ``repro.models.attention.project_qkv``: q/k/v
projection, then qk-norm, then rope — the single projection convention
the serving engine uses for both its decode step and its prefill
window.
"""
from __future__ import annotations

import torch

from .common import apply_rope, rmsnorm


def project_qkv(p: dict, xf: torch.Tensor, pos: torch.Tensor, cfg):
    """xf (b, t, d) in the compute dtype; pos (b, t) absolute positions.
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
