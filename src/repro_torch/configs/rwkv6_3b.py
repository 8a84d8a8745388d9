"""RWKV6-3B "Finch" [arXiv:2404.05892; hf] — data-dependent decay linear
recurrence, attention-free.

32L, d_model 2560, head_dim 64 (40 heads, padded to 48 for 16-way TP;
the reference's init draws the ghost heads' output-projection rows like
any other, and ``models.rwkv`` does the same), d_ff 8960
(ReLU² channel-mix in RWKV6; we follow the published relu-squared),
vocab 65536.
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv=40, head_dim=64,
        d_ff=8960, vocab=65536, act="relu2",
        rwkv_head_dim=64, rwkv_padded_heads=48,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=96, vocab=128, act="relu2",
        rwkv_head_dim=16, rwkv_padded_heads=4, max_seq=32,
    )
