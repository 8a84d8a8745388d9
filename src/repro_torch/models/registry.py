"""Model registry: family -> the functions a trainer calls.

The counterpart of ``repro.models.registry``.  The dense family is
ported (``init``, ``loss_fn``); the port keeps no
PartitionSpecs (one card), so ``ModelAPI`` has no ``specs``.  The other
families raise ``NotImplementedError`` naming their slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import lm

_LATER = {"encdec": "the encoder-decoder slice (whisper)",
          "moe": "the MoE slice (ROADMAP A4)",
          "ssm": "the RWKV slice",
          "hybrid": "the Mamba-hybrid slice",
          "vlm": "the vision-language slice"}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss_fn: Callable


def build(cfg) -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch has no {cfg.family!r} model yet: it arrives with "
            f"{_LATER.get(cfg.family, 'a later slice')}")
    return ModelAPI(init=lm.init, loss_fn=lm.loss_fn)
