"""Model registry: family -> the functions a trainer and a server call.

The counterpart of ``repro.models.registry``: ``init``, ``loss_fn`` and
the contiguous-cache serving API ``prefill``, ``decode_step`` and
``init_decode_state``.  The port keeps no PartitionSpecs (one card), so
``ModelAPI`` has no ``specs``.  Every family builds: the encoder-decoder
(whisper) from ``models.encdec``, with no ``prefill`` (as in the
reference) and a ``decode_step`` that takes the encoder's cross K/V;
every other family from ``models.lm`` (the vlm's ``decode_step`` takes
``img_kv``).  The dense, ssm, hybrid, vlm and encdec families train;
the MoE family decodes, and its ``loss_fn`` raises (MoE training is
ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from . import encdec, lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss_fn: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_decode_state: Optional[Callable] = None


def build(cfg) -> ModelAPI:
    if cfg.family == "encdec":
        return ModelAPI(init=encdec.init, loss_fn=encdec.loss_fn,
                        decode_step=encdec.decode_step,
                        init_decode_state=encdec.init_decode_state)
    if cfg.family not in lm.FAMILIES:
        raise NotImplementedError(f"repro_torch has no {cfg.family!r} "
                                  f"family (nor does the reference)")
    return ModelAPI(init=lm.init, loss_fn=lm.loss_fn, prefill=lm.prefill,
                    decode_step=lm.decode_step,
                    init_decode_state=lm.init_decode_state)
