"""Decoder-only LM for the dense and MoE families: parameters, forward,
loss, and the decode MLP.

The counterpart of ``repro.models.lm`` (dense and MoE blocks): ``init``,
``_dense_block_apply``, ``forward``, ``loss_fn`` and ``_decode_mlp``.
Parameters are a plain nested dict with the JAX pytree's keys; per-layer
weights are stacked on a leading layer axis as in the JAX pytree, and
``layer(blocks, li)`` takes one layer's views (the Python loop over
layers replaces ``jax.lax.scan``).  ``unstack`` turns the stacked blocks
into a list of per-layer dicts of views — the form the trainer
differentiates, so each layer's gradient is its own tensor; every
function here takes either form.

``init`` builds both families; a MoE block's ``mlp`` holds the router,
the stacked experts and the optional shared expert (``mlp.moe_shapes``),
and ``_decode_mlp`` routes one token per slot through ``moe_apply``, so
the serving engine runs both.  ``forward`` and ``loss_fn`` train the
dense family only: MoE training is ROADMAP A10.

Init draws from an explicit ``torch.Generator`` with the reference's
distributions: matrices normal with scale ``1/sqrt(fan_in)`` (fan_in is
``shape[0]``, which for an expert tensor is the expert count, as in the
reference), the router with scale 0.02, the embedding and head tables
normal with scale 0.02, every norm scale one.
The numbers differ from ``jax.random``'s; tests that compare the two
packages hand the JAX weights over through ``repro_torch.weights``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import self_attention
from .common import ninit, norm_apply
from .embed import embed_lookup, lm_head_loss
from .mlp import is_glu, mlp_apply, moe_apply, moe_shapes

ACTS = ("swiglu", "geglu", "relu2", "gelu")


def _block_shapes(cfg) -> dict:
    d, dh, h, hkv, ff = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv,
                         cfg.d_ff)
    attn = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
            "wo": (h * dh, d)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (dh,)}
        attn["k_norm"] = {"scale": (dh,)}
    if cfg.moe:
        mlp = moe_shapes(cfg)
    else:
        mlp = {"wu": (d, ff), "wd": (ff, d)}
        if is_glu(cfg.act):
            mlp["wg"] = (d, ff)
    return {"ln1": {"scale": (d,)}, "attn": attn, "ln2": {"scale": (d,)},
            "mlp": mlp}


def _fill(shapes, n_layers, gen, dtype, device):
    """Stacked (n_layers, ...) tensors: norm scales are ones, matrices
    and expert tensors are drawn layer by layer (bounded f32 scratch at
    full width).  An entry is a shape, or a (shape, init scale) pair for
    a matrix drawn at a fixed scale (the MoE router)."""
    out = {}
    for name, s in shapes.items():
        if isinstance(s, dict):
            out[name] = _fill(s, n_layers, gen, dtype, device)
            continue
        s, scale = s if isinstance(s[0], tuple) else (s, None)
        if len(s) == 1:
            out[name] = torch.ones((n_layers,) + s, dtype=dtype, device=device)
        else:
            t = torch.empty((n_layers,) + s, dtype=dtype, device=device)
            for li in range(n_layers):
                t[li] = ninit(gen, s, scale=scale, dtype=dtype, device=device)
            out[name] = t
    return out


def init(gen: torch.Generator, cfg, *, dtype=torch.float32,
         device=None) -> dict:
    """Dense- or MoE-family parameters: ``embed``, ``blocks`` (stacked),
    ``ln_f`` and, unless tied, ``head``."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"repro_torch lm.init builds the dense and MoE families; "
            f"{cfg.family!r} arrives in a later slice")
    if cfg.act not in ACTS:
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


def layer(blocks, li: int) -> dict:
    """Layer ``li``'s parameters: views into the stacked tensors, or the
    entry of a per-layer list."""
    if isinstance(blocks, list):
        return blocks[li]
    return {k: layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in blocks.items()}


def n_blocks(blocks) -> int:
    if isinstance(blocks, list):
        return len(blocks)
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def unstack(params: dict) -> dict:
    """The same parameters with ``blocks`` as a list of per-layer dicts of
    views into the stacked tensors (no copy)."""
    out = dict(params)
    out["blocks"] = [layer(params["blocks"], li)
                     for li in range(n_blocks(params["blocks"]))]
    return out


# ======================================================================
# forward and loss
# ======================================================================
def _dense_block_apply(p: dict, x: torch.Tensor, ctx, cfg,
                       causal: bool = True) -> torch.Tensor:
    h = self_attention(p["attn"], norm_apply("rms", p["ln1"], x), ctx, cfg,
                       causal=causal, window=cfg.swa_window)
    x = x + h
    m = mlp_apply(p["mlp"], norm_apply("rms", p["ln2"], x).to(
        ctx.compute_dtype), cfg)
    return x + m


def forward(params: dict, ids: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """ids (b, t) -> final hidden states (b, t, d).  With ``ctx.remat``
    each layer runs under ``torch.utils.checkpoint`` — its activations
    are recomputed in the backward, as the reference's checkpointed
    ``_scan`` body — so a layer's forward runs twice per step."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch trains the dense family; {cfg.family!r} arrives in "
            f"a later slice (MoE training: ROADMAP A10)")
    x = embed_lookup(params["embed"], ids, ctx.compute_dtype)
    blocks = params["blocks"]
    for li in range(n_blocks(blocks)):
        p = layer(blocks, li)
        if ctx.remat:
            x = checkpoint(_dense_block_apply, p, x, ctx, cfg,
                           use_reentrant=False)
        else:
            x = _dense_block_apply(p, x, ctx, cfg)
    return norm_apply("rms", params["ln_f"], x)


def loss_fn(params: dict, batch: dict, ctx, cfg,
            for_grad: bool = False) -> torch.Tensor:
    """batch {'tokens': (b, t+1)} -> mean next-token CE.  The head is the
    embedding table when ``cfg.tie_embeddings``.  At dp = tp = 1 the
    reference's single-seed mask and DP mean are identities, so
    ``for_grad`` changes nothing; it is kept for the reference's
    signature."""
    del for_grad
    tokens = batch["tokens"]
    ids, targets = tokens[:, :-1], tokens[:, 1:]
    x = forward(params, ids, ctx, cfg)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return lm_head_loss(head, x, targets, ctx)


def _decode_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Single-token MLP or MoE: x (b, d) -> (b, d); the MoE routes the b
    slots together, as one window of b tokens."""
    if cfg.moe:
        return moe_apply(p, x[:, None], cfg)[:, 0]
    return mlp_apply(p, x, cfg)
