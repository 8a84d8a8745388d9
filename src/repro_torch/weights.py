"""Bring the JAX package's parameters into the port.

``from_jax`` takes the JAX params pytree with its leaves as numpy
arrays — e.g. ``jax.tree.map(np.asarray, params)`` — and returns the
port's nested parameter dict with the same keys (``embed.table``,
``head.table``, ``ln_f.scale``, ``blocks.{ln1,ln2}.scale``,
``blocks.attn.{wq,wk,wv,wo,q_norm,k_norm}``, ``blocks.mlp.{wu,wg,wd}``
for a dense block or ``blocks.mlp.{router,wu,wg,wd,shared.{wu,wg,wd}}``
for a MoE block, per-layer leaves stacked on a leading layer axis).
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

_TOP_KEYS = {"embed", "head", "ln_f", "blocks"}
_MLP_KEYS = {"wu", "wg", "wd", "router", "shared"}


def _convert(tree):
    if isinstance(tree, Mapping):
        return {k: _convert(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))  # owned copy


def from_jax(params_np: Mapping) -> dict:
    """JAX dense- or MoE-LM params (a nested dict of numpy arrays) -> the
    port's parameter dict of f32 CPU tensors (``.to()`` them for a
    device)."""
    unknown = set(params_np) - _TOP_KEYS
    if unknown:
        raise NotImplementedError(
            f"from_jax converts the dense and MoE families; unexpected "
            f"top-level keys {sorted(unknown)}")
    mlp = params_np.get("blocks", {}).get("mlp", {})
    unknown = set(mlp) - _MLP_KEYS
    if unknown:
        raise NotImplementedError(
            f"from_jax converts dense and MoE blocks; unexpected "
            f"blocks.mlp keys {sorted(unknown)}")
    return _convert(params_np)
