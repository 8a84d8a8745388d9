"""Bring the JAX package's parameters into the port.

``from_jax`` takes the JAX params pytree with its leaves as numpy
arrays — e.g. ``jax.tree.map(np.asarray, params)`` — and returns the
port's nested parameter dict with the same keys (``embed.table``,
``head.table``, ``ln_f.scale``, ``blocks.{ln1,ln2}.scale``,
``blocks.attn.{wq,wk,wv,wo,q_norm,k_norm}``, ``blocks.mlp.{wu,wg,wd}``
for a dense block or ``blocks.mlp.{router,wu,wg,wd,shared.{wu,wg,wd}}``
for a MoE block, per-layer leaves stacked on a leading layer axis; an
RWKV block ``blocks.{ln1,ln2}.{scale,bias}``, ``blocks.tm.*`` and
``blocks.cm.*``; a hybrid's Mamba blocks ``blocks.{ln,mamba}`` and
``tail.{ln,mamba}``, stacked, and its ``shared`` dense block, not; the
vlm's ``cross.{xln,xattn,xgate,ln2,mlp,mgate}``, stacked; the
encoder-decoder's ``pos_dec``, ``enc_blocks``, ``dec_blocks`` (with
``lnx``/``xattn``), stacked, and ``ln_enc``).
Whatever the JAX tree holds is converted: tied embeddings (gemma) come
without ``head``, a plain-activation MLP (relu2, gelu) without ``wg``,
a MoE block without a shared expert without ``shared``.  Both packages then
compute the same function, which is how the tests hold one against the
other.  It takes numpy, never JAX arrays, so this module needs no JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_TOP_KEYS = {"embed", "head", "ln_f", "blocks", "tail", "shared", "cross",
             "pos_dec", "enc_blocks", "ln_enc", "dec_blocks"}
_MLP_KEYS = {"wu", "wg", "wd", "router", "shared"}


def _convert(tree):
    if isinstance(tree, Mapping):
        return {k: _convert(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))  # owned copy


def from_jax(params_np: Mapping) -> dict:
    """JAX params of any family but posh-micro's (a nested dict of numpy
    arrays) -> the port's parameter dict of f32 CPU tensors (``.to()``
    them for a device)."""
    unknown = set(params_np) - _TOP_KEYS
    if unknown:
        raise NotImplementedError(
            f"from_jax converts the dense, MoE, RWKV, hybrid, vlm and "
            f"encoder-decoder families; unexpected top-level keys "
            f"{sorted(unknown)}")
    for name in ("blocks", "shared", "cross", "enc_blocks", "dec_blocks"):
        mlp = params_np.get(name, {}).get("mlp", {})
        unknown = set(mlp) - _MLP_KEYS
        if unknown:
            raise NotImplementedError(
                f"from_jax converts dense, MoE and cross blocks' MLPs; "
                f"unexpected {name}.mlp keys {sorted(unknown)}")
    return _convert(params_np)


def _split_cols(w: torch.Tensor, tp: int) -> torch.Tensor:
    """(..., d, n) -> (..., tp, d, n/tp): rank t's columns, contiguous."""
    *lead, d, n = w.shape
    return w.reshape(*lead, d, tp, n // tp).movedim(-2, -3).contiguous()


def _split_rows(w: torch.Tensor, tp: int) -> torch.Tensor:
    """(..., n, d) -> (..., tp, n/tp, d): rank t's rows (a view)."""
    *lead, n, d = w.shape
    return w.reshape(*lead, tp, n // tp, d)


def _split_mlp(mlp: Mapping, tp: int) -> dict:
    """A GLU or plain MLP, column -> row parallel: ``wu``/``wg`` by
    columns, ``wd`` by rows."""
    out = dict(mlp)
    for name in ("wu", "wg"):
        if name in out:
            out[name] = _split_cols(out[name], tp)
    out["wd"] = _split_rows(out["wd"], tp)
    return out


def _check_moe_split(cfg, tp: int) -> None:
    """The reference's MoE layout at ``tp``: ``experts_padded(tp)`` experts,
    ``E/tp`` a rank, the shared expert split by columns.  The port's
    tensors hold ``experts_padded(1)``: where the reference would pad
    otherwise at ``tp`` it draws other tensors, so that raises too."""
    m = cfg.moe
    ep, ep1 = m.experts_padded(tp), m.experts_padded(1)
    if ep != ep1:
        raise ValueError(
            f"{cfg.name}: the reference pads {m.num_experts} experts to {ep} "
            f"at tp={tp} but to {ep1} at tp=1 (other tensors)")
    if ep % tp:
        raise ValueError(f"{cfg.name}: {ep} (padded) experts do not divide "
                         f"by tp={tp}")
    if m.shared_ff % tp:
        raise ValueError(f"{cfg.name}: the shared expert's ff {m.shared_ff} "
                         f"does not divide by tp={tp}")


def is_tp_sharded(params: Mapping) -> bool:
    """Whether ``params`` are already in the stacked layout of
    ``shard_for_tp`` (the vocab table then has a PE axis)."""
    return params["embed"]["table"].dim() == 3


def shard_for_tp(params: Mapping, cfg, tp: int) -> dict:
    """Full dense- or MoE-LM parameters -> the stacked ``(tp, ...)`` layout.

    The reference's specs: ``embed_specs`` (the vocab table split by
    rows, ``(tp, V/tp, d)``, also the untied head); ``attn_specs`` (head
    layout: ``wq`` by columns, ``(L, tp, d, hpr*dh)``; ``wk``/``wv`` by
    columns when ``n_kv % tp == 0``, else replicated there — here each
    rank gets the one KV head its query group reads, ``my_kv = (t*hpr)
    // group``, as the reference slices it; ``wo`` by rows); ``mlp_specs``
    (``wu``/``wg`` by columns, ``wd`` by rows); ``moe_specs`` for a MoE
    block (the experts ``wu``/``wg``/``wd`` split on their own axis,
    ``(L, E, ...)`` -> ``(L, tp, E/tp, ...)``, rank ``t`` owning experts
    ``t*E/tp ..``; the router replicated; the shared expert as the dense
    MLP).  Norm scales and the router stay replicated, one copy.  Row and
    expert splits are views of the full tensors, column splits copies
    (the caller drops the full dict, so a copy replaces its source).
    Raises when the vocab, heads, d_ff, the padded experts or the shared
    expert's width do not divide by ``tp``, when the padding the
    reference draws at ``tp`` is not the tp = 1 tensors', or for the ctx
    attention layout.  Parameters already stacked, or ``tp == 1``, come
    back as given (so engines that share one dict keep sharing it)."""
    tp = int(tp)
    if tp == 1 or is_tp_sharded(params):
        return params
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads do not divide by "
                         f"tp={tp} (the head layout needs them to)")
    for name in ("embed", "head"):
        if name in params and params[name]["table"].shape[0] % tp:
            raise ValueError(
                f"{cfg.name}: the {name} table's {params[name]['table'].shape[0]}"
                f" rows (vocab) do not divide by tp={tp}")
    if cfg.moe:
        _check_moe_split(cfg, tp)
    elif cfg.d_ff % tp:
        raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} does not divide by "
                         f"tp={tp}")
    out = {k: v for k, v in params.items() if k != "blocks"}
    for name in ("embed", "head"):
        if name in params:
            out[name] = {"table": _split_rows(params[name]["table"], tp)}
    blocks = params["blocks"]
    attn = dict(blocks["attn"])
    dh, hkv = cfg.head_dim, cfg.n_kv
    attn["wq"] = _split_cols(attn["wq"], tp)
    attn["wo"] = _split_rows(attn["wo"], tp)
    for name in ("wk", "wv"):
        w = attn[name]
        if hkv % tp == 0:
            attn[name] = _split_cols(w, tp)
        else:
            hpr, group = cfg.n_heads // tp, cfg.n_heads // hkv
            my_kv = [(t * hpr) // group for t in range(tp)]
            heads = w.reshape(w.shape[:-1] + (hkv, dh))[..., my_kv, :]
            attn[name] = heads.movedim(-2, -3).contiguous()
    mlp = dict(blocks["mlp"])
    if cfg.moe:
        for name in ("wu", "wg", "wd"):
            w = mlp[name]                           # (L, E, ...): a view
            mlp[name] = w.reshape(w.shape[:1] + (tp, -1) + w.shape[2:])
        if "shared" in mlp:
            mlp["shared"] = _split_mlp(mlp["shared"], tp)
    else:
        mlp = _split_mlp(mlp, tp)
    out["blocks"] = {**blocks, "attn": attn, "mlp": mlp}
    return out
