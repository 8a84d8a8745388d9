"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone + shared
attention blocks.

81 Mamba2 layers (d_model 3584, ssm_state 64, expand 2 ⇒ d_inner 7168,
112 ssm heads of 64) with a weight-shared attention+MLP block applied
every 6 layers (32 heads, kv=32, head_dim 112, d_ff 14336).
The shared attention uses SWA(4096).
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
        d_ff=14336, vocab=32000, act="swiglu",
        ssm_state=64, ssm_expand=2, ssm_conv=4,
        shared_attn_every=6, swa_window=4096,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=4, d_model=128, n_heads=4, n_kv=4, head_dim=32,
        d_ff=192, vocab=128, act="swiglu",
        ssm_state=8, ssm_expand=2, ssm_conv=4,
        shared_attn_every=2, swa_window=16, max_seq=32,
    )
