"""Model registry: family -> the functions a trainer and a server call.

The counterpart of ``repro.models.registry``: ``init``, ``loss_fn`` and
the contiguous-cache serving API ``prefill``, ``decode_step`` and
``init_decode_state`` (``models.lm``).  The port keeps no PartitionSpecs
(one card), so ``ModelAPI`` has no ``specs``.  The dense, ssm (RWKV) and
hybrid (Mamba + shared attention) families build, train and decode;
the MoE family builds and decodes, and its ``loss_fn`` raises (MoE
training is ROADMAP A10); the encoder-decoder and vision-language
families raise here, citing A10.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import lm

_LATER = {"encdec": "the encoder-decoder slice (whisper, ROADMAP A10)",
          "vlm": "the vision-language slice (llama-3.2-vision, ROADMAP "
                 "A10)"}


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    init_decode_state: Callable


def build(cfg) -> ModelAPI:
    if cfg.family not in lm.FAMILIES:
        raise NotImplementedError(
            f"repro_torch builds no {cfg.family!r} model yet: it arrives "
            f"with {_LATER.get(cfg.family, 'a later slice')}")
    return ModelAPI(init=lm.init, loss_fn=lm.loss_fn, prefill=lm.prefill,
                    decode_step=lm.decode_step,
                    init_decode_state=lm.init_decode_state)
