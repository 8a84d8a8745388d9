"""Model registry: family -> the functions a trainer calls.

The counterpart of ``repro.models.registry``.  The dense family trains
(``init``, ``loss_fn``); the port keeps no PartitionSpecs (one card), so
``ModelAPI`` has no ``specs``.  The MoE family is served (``lm.init``
builds it) but not trained yet; it and the other families raise
``NotImplementedError`` here, naming their slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import lm

_LATER = {"encdec": "the encoder-decoder slice (whisper)",
          "moe": "MoE training (ROADMAP A10)",
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
            f"repro_torch trains no {cfg.family!r} model yet: it arrives "
            f"with {_LATER.get(cfg.family, 'a later slice')}")
    return ModelAPI(init=lm.init, loss_fn=lm.loss_fn)
