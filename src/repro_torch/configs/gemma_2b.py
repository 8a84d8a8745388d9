"""Gemma-2B [arXiv:2403.08295; hf] — GeGLU, head_dim 256, MQA (kv=1).

18L, d_model 2048, 8 heads, d_ff 16384 (GeGLU hidden), vocab 256000,
tied embeddings.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
        d_ff=16384, vocab=256000, act="geglu", tie_embeddings=True,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=1, head_dim=32,
        d_ff=128, vocab=128, act="geglu", tie_embeddings=True, max_seq=32,
    )
