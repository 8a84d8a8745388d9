"""Model registry: family -> the functions a trainer and a server call.

The counterpart of ``repro.models.registry``: ``init``, ``loss_fn`` and
the contiguous-cache serving API ``prefill``, ``decode_step`` and
``init_decode_state``.  Every family builds: the encoder-decoder
(whisper) from ``models.encdec``, with no ``prefill`` (as in the
reference) and a ``decode_step`` that takes the encoder's cross K/V;
every other family from ``models.lm`` (the vlm's ``decode_step`` takes
``img_kv``).  Every family trains and decodes at any tp, in either
attention layout.

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

from . import encdec, lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss_fn: Callable
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    init_decode_state: Optional[Callable] = None


def require_model(cfg) -> None:
    """Raise for a config that describes no model: posh-micro (family
    ``micro``) is the paper's communication sweep — buffer sizes,
    dtypes, repeats — with no weights to build, train or serve, as in
    the reference."""
    if cfg.family == "micro":
        raise ValueError(
            f"{cfg.name} is the communication sweep's configuration (buffer "
            f"sizes, dtypes, repeats), not a model: it has no weights to "
            f"build, train or serve; examples/torch/shmem_pingpong.py runs "
            f"its sweep")


def build(cfg) -> ModelAPI:
    require_model(cfg)
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


def _norm(kind: str = "rms") -> dict:
    return {"scale": None, "bias": None} if kind == "layer" else \
        {"scale": None}


def _attn(cfg, tp: int) -> dict:
    """``attn_specs``: the head layout splits ``wq`` by columns, ``wk`` /
    ``wv`` by columns when ``n_kv % tp == 0`` (else replicated) and ``wo``
    by rows; the ctx layout replicates every leaf."""
    if cfg.attn_layout(tp) == "head":
        kv = 1 if cfg.n_kv % tp == 0 else None
        attn = {"wq": 1, "wk": kv, "wv": kv, "wo": 0}
    else:
        attn = {"wq": None, "wk": None, "wv": None, "wo": None}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": None}
        attn["k_norm"] = {"scale": None}
    return attn


def _mlp(cfg) -> dict:
    """The dense MLP column -> row (``wg`` for a GLU only)."""
    glu = {"wu": 1, "wg": 1, "wd": 0}
    return {k: v for k, v in glu.items()
            if k != "wg" or cfg.act in ("swiglu", "geglu")}


def _dense_block(cfg, tp: int) -> dict:
    if cfg.moe:
        mlp = {"router": None, "wu": 0, "wg": 0, "wd": 0}
        if cfg.moe.shared_ff:
            mlp["shared"] = {"wu": 1, "wg": 1, "wd": 0}
    else:
        mlp = _mlp(cfg)
    return {"ln1": _norm(), "attn": _attn(cfg, tp), "ln2": _norm(),
            "mlp": mlp}


def _rwkv_block() -> dict:
    """``timemix_specs`` / ``chanmix_specs``: the per-head projections and
    vectors by their head axis, ``wo`` and the channel mix's ``wv`` by
    rows, the mixes, LoRAs and ``wr`` replicated."""
    tm = {k: None for k in ("mu_x", "mu5", "lora_w1", "lora_w2", "ww1")}
    tm.update({k: 1 for k in ("wr", "wk", "wv", "wg", "ww2")})
    tm.update({k: 0 for k in ("w0", "u", "gn_scale", "gn_bias", "wo")})
    cm = {"mu_k": None, "mu_r": None, "wk": 1, "wv": 0, "wr": None}
    return {"ln1": _norm("layer"), "tm": tm, "ln2": _norm("layer"),
            "cm": cm}


def _mamba_block() -> dict:
    """``mamba_specs``: ``d_inner`` by heads, B / C replicated."""
    m = {k: 1 for k in ("wz", "wx", "wdt", "conv_x")}
    m.update({k: 0 for k in ("dt_bias", "A_log", "D", "norm_scale", "wo")})
    m.update({k: None for k in ("wB", "wC", "conv_B", "conv_C")})
    return {"ln": _norm(), "mamba": m}


def tp_specs(cfg, tp: int) -> dict:
    """Each parameter's TP sharding at ``tp``, the reference's specs
    (``embed_specs``, ``attn_specs`` in either layout, ``mlp_specs``,
    ``moe_specs``, ``timemix_specs`` / ``chanmix_specs``,
    ``mamba_specs``, ``norm_specs`` and the families' block and model
    specs) read as the axis of the per-layer leaf that ``P(...,
    "model", ...)`` names, or None for a replicated leaf (``P()`` /
    ``P(None, ...)``): the vocab tables by rows, the experts on their
    own axis, the column- and row-parallel matrices as the layers split
    them; norms, the router, the vlm's gates, whisper's ``pos_dec`` and
    every attention leaf of the ctx layout replicated.  A stacked
    group's entry (``tree.STACKED``) is one layer's dict (the reference
    stacks it on a layer axis, in front); the hybrid's ``shared`` block
    is one dense block."""
    require_model(cfg)
    fam = cfg.family
    if fam == "encdec":
        enc = {"ln1": _norm("layer"), "attn": _attn(cfg, tp),
               "ln2": _norm("layer"), "mlp": _mlp(cfg)}
        return {"embed": {"table": 0}, "pos_dec": None, "enc_blocks": enc,
                "ln_enc": _norm("layer"),
                "dec_blocks": {**enc, "lnx": _norm("layer"),
                               "xattn": _attn(cfg, tp)},
                "ln_f": _norm("layer")}
    out = {"embed": {"table": 0}, "ln_f": _norm()}
    if fam in ("dense", "moe", "vlm"):
        out["blocks"] = _dense_block(cfg, tp)
    if fam == "vlm":
        out["cross"] = {"xln": _norm(), "xattn": _attn(cfg, tp),
                        "xgate": None, "ln2": _norm(), "mlp": _mlp(cfg),
                        "mgate": None}
    elif fam == "ssm":
        out["blocks"] = _rwkv_block()
    elif fam == "hybrid":
        out["blocks"] = _mamba_block()
        if cfg.n_layers % cfg.shared_attn_every:
            out["tail"] = _mamba_block()
        out["shared"] = _dense_block(cfg, tp)
    if not cfg.tie_embeddings:
        out["head"] = {"table": 0}
    return out
