"""Decoder-only LM parameters for the dense family, and the decode MLP.

The counterpart of ``repro.models.lm.init`` (dense branch) and
``lm._decode_mlp``.  Parameters are a plain nested dict with the JAX
pytree's keys; per-layer weights are stacked on a leading layer axis as
in the JAX pytree, and ``layer(blocks, li)`` takes one layer's views
(the Python loop over layers replaces ``jax.lax.scan``).

Init draws from an explicit ``torch.Generator`` with the reference's
distributions: matrices normal with scale ``1/sqrt(fan_in)``, the
embedding and head tables normal with scale 0.02, every norm scale one.
The numbers differ from ``jax.random``'s; tests that compare the two
packages hand the JAX weights over through ``repro_torch.weights``.
"""
from __future__ import annotations

import torch

from .common import ninit
from .mlp import mlp_apply


def _block_shapes(cfg) -> dict:
    d, dh, h, hkv, ff = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv,
                         cfg.d_ff)
    attn = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
            "wo": (h * dh, d)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (dh,)}
        attn["k_norm"] = {"scale": (dh,)}
    return {"ln1": {"scale": (d,)}, "attn": attn, "ln2": {"scale": (d,)},
            "mlp": {"wu": (d, ff), "wd": (ff, d), "wg": (d, ff)}}


def _fill(shapes, n_layers, gen, dtype, device):
    """Stacked (n_layers, ...) tensors: norm scales are ones, matrices
    are drawn layer by layer (bounded f32 scratch at full width)."""
    out = {}
    for name, s in shapes.items():
        if isinstance(s, dict):
            out[name] = _fill(s, n_layers, gen, dtype, device)
        elif len(s) == 1:
            out[name] = torch.ones((n_layers,) + s, dtype=dtype, device=device)
        else:
            t = torch.empty((n_layers,) + s, dtype=dtype, device=device)
            for li in range(n_layers):
                t[li] = ninit(gen, s, dtype=dtype, device=device)
            out[name] = t
    return out


def init(gen: torch.Generator, cfg, *, dtype=torch.float32,
         device=None) -> dict:
    """Dense-family parameters: ``embed``, ``blocks`` (stacked),
    ``ln_f`` and, unless tied, ``head``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch lm.init builds the dense family; {cfg.family!r} "
            f"arrives in a later slice")
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act {cfg.act!r} not ported")
    v, d = cfg.padded_vocab(1), cfg.d_model
    params = {"embed": {"table": ninit(gen, (v, d), scale=0.02, dtype=dtype,
                                       device=device)},
              "blocks": _fill(_block_shapes(cfg), cfg.n_layers, gen, dtype,
                              device),
              "ln_f": {"scale": torch.ones((d,), dtype=dtype, device=device)}}
    if not cfg.tie_embeddings:
        params["head"] = {"table": ninit(gen, (v, d), scale=0.02,
                                         dtype=dtype, device=device)}
    return params


def layer(blocks: dict, li: int) -> dict:
    """Layer ``li``'s parameters as views into the stacked tensors."""
    return {k: layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in blocks.items()}


def _decode_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Single-token MLP: x (b, d) -> (b, d)."""
    if cfg.moe:
        raise NotImplementedError(
            "MoE serving arrives in a later slice of the port")
    return mlp_apply(p, x, cfg)
