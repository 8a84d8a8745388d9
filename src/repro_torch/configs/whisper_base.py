"""Whisper-base [arXiv:2212.04356] — encoder-decoder backbone.

6 encoder + 6 decoder layers, d_model 512, 8 heads (head_dim 64),
d_ff 2048, vocab 51865 (padded to 51872 for vocab-parallel TP).
Conv frontend is a STUB: input_specs provides precomputed frame
embeddings (1500 frames after 2x conv downsampling).
"""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="encdec",
        n_layers=6, enc_layers=6, enc_frames=1500,
        d_model=512, n_heads=8, n_kv=8, head_dim=64,
        d_ff=2048, vocab=51865, act="gelu", use_rope=False,
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base-smoke", family="encdec",
        n_layers=2, enc_layers=2, enc_frames=24,
        d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=96, vocab=128, act="gelu", use_rope=False, max_seq=32,
    )
