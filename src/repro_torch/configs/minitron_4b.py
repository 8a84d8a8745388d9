"""Minitron-4B — width-pruned Nemotron [arXiv:2407.14679; hf].

32L, d_model 3072, 24 query heads (GQA kv=8, head_dim 128), d_ff 9216
(squared-ReLU in the paper's base model; public HF config uses
squared-relu — we use swiglu-free 'relu2'), vocab 256000.
24 heads % 16 TP ⇒ ctx attention layout.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv=8, head_dim=128,
        d_ff=9216, vocab=256000, act="relu2", rope_theta=10000.0,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=6, n_kv=2, head_dim=16,
        d_ff=96, vocab=128, act="relu2", max_seq=32,
    )
