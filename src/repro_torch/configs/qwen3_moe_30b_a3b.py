"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128 experts top-8.

48L, d_model 2048, 32 heads (GQA kv=4, head_dim 128), expert_ff 768,
vocab 151936, qk_norm.  128 experts / 16 TP = 8 per rank.
"""
from .base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv=4, head_dim=128,
        d_ff=768, vocab=151936, act="swiglu", qk_norm=True,
        rope_theta=1000000.0,
        moe=MoEConfig(num_experts=128, top_k=8, expert_ff=768),
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=48, vocab=128, act="swiglu", qk_norm=True, max_seq=32,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=48,
                      capacity_factor=8.0),
    )
