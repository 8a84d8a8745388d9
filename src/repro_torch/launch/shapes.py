"""The assigned input-shape sets and their input builders for the dry
run (counterpart of ``repro.launch.shapes``).  The builders return
**meta** tensors: shapes and dtypes, no storage.

LM shapes:   train_4k (train_step), prefill_32k (prefill),
             decode_32k (serve_step: 1 new token, 32k cache),
             long_500k (serve_step, 512k context; sub-quadratic only)
"""
from __future__ import annotations

import math

import torch

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}

# archs with quadratic full attention skip long_500k (DESIGN.md §5)
LONG_OK = {"h2o-danube-3-4b", "rwkv6-3b", "zamba2-7b"}

# per-(arch, shape) microbatch counts for train_4k (activation memory)
TRAIN_MICROBATCH = {
    "llama-3.2-vision-90b": 8,
    "qwen3-8b": 4,
    "zamba2-7b": 4,
    "default": 2,
}

META = torch.device("meta")


def microbatches_for(arch: str) -> int:
    return TRAIN_MICROBATCH.get(arch, TRAIN_MICROBATCH["default"])


def runs_shape(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in LONG_OK:
        return False, "full quadratic attention at 512k — documented skip"
    return True, ""


def dp_axes_of(team):
    return tuple(a for a in team.axes if a != "model")


def dp_size_of(team) -> int:
    sizes = dict(zip(team.axes, team.sizes))
    return math.prod(sizes[a] for a in dp_axes_of(team))


def side_inputs(cfg, rows: int, dtype) -> dict:
    """The vlm's image embeddings, whisper's frames."""
    if cfg.family == "vlm":
        return {"img_embeds": torch.empty((rows, cfg.img_tokens,
                                           cfg.d_model), dtype=dtype,
                                          device=META)}
    if cfg.family == "encdec":
        return {"frames": torch.empty((rows, cfg.enc_frames, cfg.d_model),
                                      dtype=dtype, device=META)}
    return {}


def train_inputs(cfg, shape_name: str, *, global_batch=None, seq=None,
                 dtype=torch.bfloat16) -> dict:
    """The global batch of a training step (the trainer splits it by
    rows over the DP replicas): ``tokens`` (gb, t + 1) int32, and the
    vlm's ``img_embeds`` or whisper's ``frames``."""
    info = SHAPES[shape_name]
    gb = global_batch or info["global_batch"]
    t = seq or info["seq"]
    return {"tokens": torch.empty((gb, t + 1), dtype=torch.int32,
                                  device=META), **side_inputs(cfg, gb, dtype)}


def prefill_inputs(cfg, shape_name: str, *, global_batch=None, seq=None,
                   dtype=torch.bfloat16) -> dict:
    """The global batch of a prefill: ``tokens`` (gb, t) int32, and the
    side inputs."""
    info = SHAPES[shape_name]
    gb = global_batch or info["global_batch"]
    t = seq or info["seq"]
    return {"tokens": torch.empty((gb, t), dtype=torch.int32, device=META),
            **side_inputs(cfg, gb, dtype)}


def decode_batch_info(cfg, team, shape_name: str):
    """(b_local, max_len, batch_replicated) for decode state building."""
    info = SHAPES[shape_name]
    dp = dp_size_of(team)
    gb = info["global_batch"]
    if gb >= dp:
        return gb // dp, info["seq"], False
    return gb, info["seq"], True  # replicate small batches (long_500k b=1)
