"""Model registry: family -> the functions a trainer and a server call.

The counterpart of ``repro.models.registry``: ``init``, ``loss_fn`` and
the contiguous-cache serving API ``prefill``, ``decode_step`` and
``init_decode_state``.  Every family builds: the encoder-decoder
(whisper) from ``models.encdec``, with no ``prefill`` (as in the
reference) and a ``decode_step`` that takes the encoder's cross K/V;
every other family from ``models.lm`` (the vlm's ``decode_step`` takes
``img_kv``).  Every family trains at tp = 1; the dense and MoE families
at tp > 1 too, in the head attention layout.

``tp_specs`` is the counterpart of the reference's ``api.specs`` for
the one thing the port reads of a PartitionSpec: whether a leaf is
sharded over TP, and on which axis.  It is the one place the trainer's
TP completion (``train.grad.tp_complete``), the TP layout of serving
and training (``weights.shard_for_tp``) and its inverse (``weights.unshard``)
read.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.parallel.ctx import A10_TP

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


def tp_specs(cfg, tp: int) -> dict:
    """Each parameter's TP sharding at ``tp``, the reference's specs
    (``embed_specs``, ``attn_specs`` in the head layout, ``mlp_specs``,
    ``moe_specs``, ``norm_specs``) read as the axis of the per-layer
    leaf that ``P(..., "model", ...)`` names, or None for a replicated
    leaf (``P()`` / ``P(None, ...)``): the vocab tables by rows, ``wq``
    by columns, ``wk``/``wv`` by columns when ``n_kv % tp == 0`` (else
    replicated), ``wo`` by rows, the dense MLP and the shared expert
    column -> row, the experts on their own axis; norms and the router
    replicated.  ``blocks`` is one layer's dict (the reference stacks
    it on a layer axis, in front).  The dense and MoE families in the
    head layout only: the others, and the ctx layout, raise (A10)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family "
                                  f"at tp={tp}: {A10_TP}")
    if cfg.attn_layout(tp) != "head":
        raise NotImplementedError(f"{cfg.name}: the ctx attention layout "
                                  f"({cfg.n_heads} heads at tp={tp}): "
                                  f"{A10_TP}")
    kv = 1 if cfg.n_kv % tp == 0 else None
    attn = {"wq": 1, "wk": kv, "wv": kv, "wo": 0}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": None}
        attn["k_norm"] = {"scale": None}
    glu = {"wu": 1, "wg": 1, "wd": 0}
    if cfg.moe:
        mlp = {"router": None, "wu": 0, "wg": 0, "wd": 0}
        if cfg.moe.shared_ff:
            mlp["shared"] = dict(glu)
    else:
        mlp = {k: v for k, v in glu.items()
               if k != "wg" or cfg.act in ("swiglu", "geglu")}
    out = {"embed": {"table": 0}, "ln_f": {"scale": None},
           "blocks": {"ln1": {"scale": None}, "attn": attn,
                      "ln2": {"scale": None}, "mlp": mlp}}
    if not cfg.tie_embeddings:
        out["head"] = {"table": 0}
    return out
