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

from repro_torch.tree import STACKED

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


def map_tp(fn, params: Mapping, spec: Mapping, block: bool = False):
    """``fn(leaf, axis, block)`` over a parameter tree in the reference's
    stacked layout and its ``registry.tp_specs`` tree; ``block`` is True
    under a stacked group (``tree.STACKED``: leaves with a leading layer
    axis)."""
    if not isinstance(params, Mapping):
        return fn(params, spec, block)
    if set(params) != set(spec):
        raise ValueError(f"parameter keys {sorted(params)} differ from the "
                         f"TP spec's {sorted(spec)}")
    return {k: map_tp(fn, v, spec[k], block or k in STACKED)
            for k, v in params.items()}


def shard_leaf(w: torch.Tensor, axis, block: bool, tp: int) -> torch.Tensor:
    """One global leaf -> every PE's, stacked on a new PE axis (behind the
    layer axis of a block leaf): the ``tp`` contiguous chunks of ``axis``
    — a view when ``axis`` is the leaf's first (the PE axis then splits
    it in place), else new storage — or, for a replicated leaf (``axis``
    None), ``tp`` copies, each PE's own storage."""
    lead = int(block)
    if axis is None:
        return w.unsqueeze(lead).expand(
            w.shape[:lead] + (tp,) + w.shape[lead:]).contiguous()
    a = axis + lead
    if w.shape[a] % tp:
        raise ValueError(f"axis {axis} of a {tuple(w.shape)} leaf does not "
                         f"divide by tp={tp}")
    if axis == 0:
        return w.unflatten(a, (tp, -1))
    return torch.stack(w.chunk(tp, dim=a), dim=lead)


def unshard_leaf(w: torch.Tensor, axis, block: bool) -> torch.Tensor:
    """The inverse of ``shard_leaf``: the PEs' chunks concatenated back on
    ``axis``, or PE 0's copy of a replicated leaf (the reference's
    ``out_specs=P()`` returns device 0's).  A new tensor."""
    lead = int(block)
    if axis is None:
        return w.select(lead, 0).clone()
    return torch.cat(w.unbind(lead), dim=axis + lead)


def _check_split(cfg, tp: int) -> None:
    """Raise where a width the reference splits over TP does not divide
    by ``tp``: the MLP's (or the experts', ``_check_moe_split``), the
    RWKV padded heads, the SSD heads of ``d_inner``."""
    from repro_torch.models.registry import require_model
    require_model(cfg)
    widths = []
    if cfg.family == "ssm":
        widths.append(("padded RWKV heads", cfg.rwkv_padded_heads
                       or cfg.n_heads))
    if cfg.family == "hybrid":
        widths.append(("SSD heads", cfg.ssm_expand * cfg.d_model // 64))
    if cfg.moe:
        _check_moe_split(cfg, tp)
    else:
        widths.append(("d_ff", cfg.d_ff))
    for what, n in widths:
        if n % tp:
            raise ValueError(f"{cfg.name}: {n} {what} do not divide by "
                             f"tp={tp}")


def shard_for_tp(params: Mapping, cfg, tp: int) -> dict:
    """Global parameters of any family (the reference's stacked layout)
    -> the TP layout, for serving and training alike: EVERY leaf stacked
    per PE, ``(tp, ...)``, behind the layer axis of a stacked group's
    leaf, ``(L, tp, ...)``.  A sharded leaf (``registry.tp_specs``: the
    vocab tables and the row-parallel matrices by rows, the
    column-parallel ones and the per-head vectors by columns, the
    experts on their own axis, rank ``t`` owning experts ``t E/tp ..``)
    gives each PE its chunk, as the reference's PartitionSpec does; a
    replicated one (the norms, the router, ``wk`` / ``wv`` when ``n_kv %
    tp != 0``, every attention leaf of the ctx layout, the token-shift
    mixes, B / C, the gates, ``pos_dec``) gives each PE its own copy, so
    that in training each PE's gradient lands in its own row and the
    per-PE clip can part the copies, as the reference's.  A replicated
    ``wk`` / ``wv`` of the head layout stays whole: each PE slices the
    KV head its query group reads in the forward
    (``attention.project_qkv``).  Row and expert splits are views of the
    global tensors, the rest new storage (the caller drops the global
    dict, so a copy replaces its source).  Raises when the vocab, d_ff,
    the RWKV or SSD heads, the padded experts or the shared expert's
    width do not divide by ``tp``, or when the padding the reference
    draws at ``tp`` is not the tp = 1 tensors'.  Parameters already
    stacked, or ``tp == 1``, come back as given (so engines that share
    one dict keep sharing it)."""
    from repro_torch.models.registry import require_model, tp_specs
    require_model(cfg)
    tp = int(tp)
    if tp == 1 or is_tp_sharded(params):
        return params
    for name in ("embed", "head"):
        if name in params and params[name]["table"].shape[0] % tp:
            raise ValueError(
                f"{cfg.name}: the {name} table's {params[name]['table'].shape[0]}"
                f" rows (vocab) do not divide by tp={tp}")
    _check_split(cfg, tp)
    return map_tp(lambda w, a, blk: shard_leaf(w, a, blk, tp), params,
                  tp_specs(cfg, tp))


def unshard(params: Mapping, cfg, tp: int) -> dict:
    """The inverse of ``shard_for_tp``: the global tree in the reference's
    layout (each sharded leaf's chunks concatenated, PE 0's copy of a
    replicated leaf), new tensors.  Tests and checkpoints read the
    port's TP state through it."""
    from repro_torch.models.registry import tp_specs
    return map_tp(unshard_leaf, params, tp_specs(cfg, int(tp)))
