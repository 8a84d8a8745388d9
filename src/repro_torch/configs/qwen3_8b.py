"""Qwen3-8B [hf:Qwen/Qwen3-8B] — qk_norm, GQA kv=8.

36L, d_model 4096, 32 heads (head_dim 128), d_ff 12288, vocab 151936.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=12288, vocab=151936, act="swiglu", qk_norm=True,
        rope_theta=1000000.0,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=128, act="swiglu", qk_norm=True, max_seq=32,
    )
