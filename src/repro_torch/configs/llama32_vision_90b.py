"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-90B-Vision; unverified]
— text backbone with cross-attention image layers.

100L, d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 28672,
vocab 128256.  Cross-attention to STUB patch embeddings every 5th layer
(20 cross-attn layers).  The vision tower is a stub: input_specs
provides precomputed patch embeddings.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
        d_ff=28672, vocab=128256, act="swiglu", rope_theta=500000.0,
        cross_attn_every=5, img_tokens=1601,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=128, act="swiglu",
        cross_attn_every=2, img_tokens=12, max_seq=32,
    )
