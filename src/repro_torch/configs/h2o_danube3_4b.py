"""H2O-Danube3-4B [arXiv:2401.16818-family; unverified] — llama+mistral
mix with sliding-window attention.

24L, d_model 3840, 32 heads (GQA kv=8, head_dim 120), d_ff 10240,
vocab 32000, SWA window 4096.  SWA ⇒ long_500k runs (sub-quadratic).
head_dim 3840/32 = 120 (not 128-aligned; noted for MXU padding).
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv=8, head_dim=120,
        d_ff=10240, vocab=32000, act="swiglu", swa_window=4096,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=128, act="swiglu", swa_window=16, max_seq=32,
    )
