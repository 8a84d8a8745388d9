"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 heads (kv=16, head_dim 128), vocab 151936.
MoE: 60 routed experts top-4 (expert_ff 1408) + 4 shared experts
(fused shared hidden 5632).  60 experts padded to 64 for 16-way EP.
"""
from .base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
        d_ff=1408, vocab=151936, act="swiglu",
        moe=MoEConfig(num_experts=60, top_k=4, expert_ff=1408,
                      shared_ff=5632, padded_experts=64),
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=64, vocab=128, act="swiglu", max_seq=32,
        moe=MoEConfig(num_experts=6, top_k=2, expert_ff=64, shared_ff=96,
                      padded_experts=8, capacity_factor=8.0),
    )
