"""Decoder-only LM for the dense, MoE, RWKV (ssm), Mamba-hybrid and
vision-language (vlm) families: parameters, forward, loss, and the
contiguous-cache decode.

The counterpart of ``repro.models.lm``: ``init``, the blocks
(``_dense_block_apply``, ``_rwkv_block_apply``, ``_mamba_block_apply``),
``_cross_block_apply``), ``forward``, ``loss_fn``, ``_decode_mlp``, and
the serving API ``init_decode_state``, ``decode_step`` and ``prefill``.
Parameters are a plain nested dict with the JAX pytree's keys;
per-layer weights are stacked on a leading layer axis as in the JAX
pytree, and ``layer(blocks, li)`` takes one layer's views (the Python
loop over layers replaces ``jax.lax.scan``).  ``unstack`` turns every
stacked group (``tree.STACKED``: ``blocks``, the hybrid's ``tail``, the
vlm's ``cross``, the encoder-decoder's ``enc_blocks``/``dec_blocks``)
into a list of per-layer dicts of views — the form the trainer
differentiates, so each layer's gradient is its own tensor; every
function here takes either form.

Families and their trees:
  dense / moe  ``blocks`` of attention + MLP (or MoE) layers;
  ssm          rwkv6-3b: ``blocks`` of time-mix + channel-mix layers
               (``ln1``/``ln2`` layer norms with bias; ``ln_f`` RMS);
  hybrid       zamba2-7b: ``blocks`` of ``ng * k`` Mamba2 layers (k =
               ``shared_attn_every``), ``tail`` of the ``n_layers % k``
               left, and ``shared``, ONE dense block (unstacked) applied
               after every group of k — its gradient accumulates over its
               applications;
  vlm          llama-3.2-vision-90b: ``blocks`` of ``ng * (k - 1)`` dense
               layers (k = ``cross_attn_every``, ng = ``n_layers / k``)
               and ``cross`` of ng gated cross-attention layers
               (``xln``, ``xattn``, ``xgate``, ``ln2``, ``mlp``,
               ``mgate``; both gates zero at init, as the reference's):
               group g runs its k - 1 dense layers, then its cross layer
               attends to the image embeddings (``img_embeds``, (b,
               img_tokens, d)) through ``attention.cross_kv``.
A MoE block's ``mlp`` holds the router, the stacked experts and the
optional shared expert (``mlp.moe_shapes``); it trains (``mlp.moe_apply``
differentiates), prefills and decodes.  The encoder-decoder family is
``models.encdec``.

At tp > 1 every family trains, in either attention layout
(``weights.shard_for_tp``'s stacked parameters): the embedding's
partial rows are reduce-scattered over the sequence (``_embed_sp``),
every block runs under sequence parallelism and ``forward``
returns each PE's sequence shard (tp, b, t/tp, d); ``loss_fn`` returns
every PE's loss (tp,), and with ``for_grad`` the reference's
single-seed mask: the loss on TP rank 0, zero elsewhere, so that the
backward (seeded on every PE) computes each PE's replica-local partial
gradient once, which the train step completes per spec.  The vlm's
image embeddings (b, img_tokens, d) are the same on every PE: each PE
projects its copy (``cross_kv``).  The decode runs at tp > 1 too, on
every PE's copy of the token's hidden state (tp, b, d), each layer's
state stacked per PE behind the layer axis; the logits are each PE's
vocab shard and ``decode_step``'s greedy pick merges them
(``tp_argmax``).

Decode keeps the reference's state layout, each per-layer leaf stacked
on a leading layer axis: a dense layer's bf16 KV cache (``attention.
init_cache``), an RWKV layer's ``S``/``x_prev_tm``/``x_prev_cm``, a
Mamba layer's SSM state and bf16 conv buffers, and the vlm's
``cross_cache`` (ng zero caches, which the reference allocates and its
decode never reads: the cross layers read ``img_kv``, each group's
``cross_kv`` of the image embeddings, stacked ``(ng, b, S, H_kv,
dh)``); ``pos`` is a Python int.
``decode_step`` updates the state IN PLACE and returns it.  The hybrid
threads ONE ``shared_cache`` through all its applications of the shared
block, as the reference does: each application writes slot ``pos`` with
its own K/V, so at a later step every application reads the K/V the
last one wrote (training gives each application its own; ROADMAP §C).

Init draws from an explicit ``torch.Generator`` with the reference's
distributions: matrices normal with scale ``1/sqrt(fan_in)`` (fan_in is
``shape[0]``, which for an expert tensor is the expert count, as in the
reference), the router with scale 0.02, the embedding and head tables
normal with scale 0.02, every norm scale one (a layer norm's bias zero),
the RWKV and Mamba constants as ``models.rwkv`` / ``models.ssm`` set
them.  The numbers differ from ``jax.random``'s; tests that compare the
two packages hand the JAX weights over through ``repro_torch.weights``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.parallel.ctx import sp_gather, sp_scatter, tp_of
from repro_torch.tree import STACKED, tree_map

from . import rwkv as rk
from . import ssm as sm
from .attention import (cross_attention, cross_kv, decode_cross_attention,
                        decode_self_attention, init_cache, self_attention)
from .common import ninit, norm_apply, norm_init, pe_vec
from .embed import embed_lookup, lm_head_logits, lm_head_loss, tp_argmax
from .mlp import is_glu, mlp_apply, moe_apply, moe_shapes

ACTS = ("swiglu", "geglu", "relu2", "gelu")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
_REFUSALS = {"encdec": "the encoder-decoder family is models.encdec's"}


def _refuse(cfg, what: str):
    raise NotImplementedError(
        f"repro_torch {what} no {cfg.family!r} model: "
        f"{_REFUSALS.get(cfg.family, 'not in the reference either')}")


def attn_shapes(cfg) -> dict:
    """An attention layer's weights (self or cross: the reference's
    ``attn_init`` draws the same tree for both)."""
    d, dh, h, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    attn = {"wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
            "wo": (h * dh, d)}
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": (dh,)}
        attn["k_norm"] = {"scale": (dh,)}
    return attn


def mlp_shapes(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    mlp = {"wu": (d, ff), "wd": (ff, d)}
    if is_glu(cfg.act):
        mlp["wg"] = (d, ff)
    return mlp


def _block_shapes(cfg) -> dict:
    d = cfg.d_model
    return {"ln1": {"scale": (d,)}, "attn": attn_shapes(cfg),
            "ln2": {"scale": (d,)},
            "mlp": moe_shapes(cfg) if cfg.moe else mlp_shapes(cfg)}


def draw(shapes: dict, gen, dtype, device) -> dict:
    """One layer's tensors of ``shapes`` (``_fill``'s rule): norm scales
    ones, matrices normal at ``1/sqrt(fan_in)``."""
    return {k: draw(s, gen, dtype, device) if isinstance(s, dict)
            else (torch.ones(s, dtype=dtype, device=device) if len(s) == 1
                  else ninit(gen, s, dtype=dtype, device=device))
            for k, s in shapes.items()}


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


def _stack(n: int, one, dtype, device):
    """Stack ``n`` draws of ``one()`` (a nested dict of tensors) on a new
    leading axis, allocated from the first draw and filled layer by
    layer (bounded scratch at full width)."""
    out = None
    for li in range(n):
        draw = one()
        if out is None:
            out = _alloc(draw, n, dtype, device)
        _put(out, draw, li)
    return out


def _alloc(tree, n, dtype, device):
    if isinstance(tree, dict):
        return {k: _alloc(v, n, dtype, device) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=dtype, device=device)


def _put(out, tree, li):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(out[k], v, li)
    else:
        out[li] = tree


def _rwkv_block_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {"ln1": norm_init("layer", d, dtype, device),
            "tm": rk.timemix_init(gen, cfg, dtype, device),
            "ln2": norm_init("layer", d, dtype, device),
            "cm": rk.chanmix_init(gen, cfg, dtype, device)}


def _mamba_block_init(gen, cfg, dtype, device) -> dict:
    return {"ln": norm_init("rms", cfg.d_model, dtype, device),
            "mamba": sm.mamba_init(gen, cfg, dtype, device)}


def _cross_block_init(gen, cfg, dtype, device) -> dict:
    """The vlm's gated cross-attention layer; both gates start at zero,
    so at init the layer passes its input through."""
    d = cfg.d_model
    return {"xln": norm_init("rms", d, dtype, device),
            "xattn": draw(attn_shapes(cfg), gen, dtype, device),
            "xgate": torch.zeros((1,), dtype=dtype, device=device),
            "ln2": norm_init("rms", d, dtype, device),
            "mlp": draw(mlp_shapes(cfg), gen, dtype, device),
            "mgate": torch.zeros((1,), dtype=dtype, device=device)}


def init(gen: torch.Generator, cfg, *, dtype=torch.float32,
         device=None, tp: int = 1) -> dict:
    """Parameters of any ported family: ``embed``, ``ln_f``, the family's
    blocks (module docstring) and, unless tied, ``head``; the vocab
    tables padded to a multiple of ``tp`` rows (``padded_vocab``), as the
    reference's init pads them for its TP size."""
    if cfg.family not in FAMILIES:
        _refuse(cfg, "builds")
    if cfg.family != "ssm" and cfg.act not in ACTS:
        raise NotImplementedError(f"act {cfg.act!r} not ported")
    v, d = cfg.padded_vocab(tp), cfg.d_model
    params = {"embed": {"table": ninit(gen, (v, d), scale=0.02, dtype=dtype,
                                       device=device)},
              "ln_f": norm_init("rms", d, dtype, device)}
    if cfg.family in ("dense", "moe"):
        params["blocks"] = _fill(_block_shapes(cfg), cfg.n_layers, gen,
                                 dtype, device)
    elif cfg.family == "ssm":
        params["blocks"] = _stack(
            cfg.n_layers, lambda: _rwkv_block_init(gen, cfg, dtype, device),
            dtype, device)
    elif cfg.family == "vlm":
        k = cfg.cross_attn_every
        ng = cfg.n_layers // k
        params["blocks"] = _fill(_block_shapes(cfg), ng * (k - 1), gen,
                                 dtype, device)
        params["cross"] = _stack(
            ng, lambda: _cross_block_init(gen, cfg, dtype, device), dtype,
            device)
    else:
        k = cfg.shared_attn_every
        ng, rem = divmod(cfg.n_layers, k)
        one = lambda: _mamba_block_init(gen, cfg, dtype, device)  # noqa: E731
        params["blocks"] = _stack(ng * k, one, dtype, device)
        if rem:
            params["tail"] = _stack(rem, one, dtype, device)
        params["shared"] = layer(_fill(_block_shapes(cfg), 1, gen, dtype,
                                       device), 0)
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
    """The same parameters with every stacked group (``tree.STACKED``) as
    a list of per-layer dicts of views into the stacked tensors (no
    copy); the hybrid's ``shared`` block stays one dict."""
    out = dict(params)
    for key in STACKED:
        if key in params:
            out[key] = [layer(params[key], li)
                        for li in range(n_blocks(params[key]))]
    return out


# ======================================================================
# forward and loss
# ======================================================================
def _dense_block_apply(p: dict, x: torch.Tensor, ctx, cfg,
                       causal: bool = True) -> torch.Tensor:
    h = self_attention(p["attn"], norm_apply("rms", p["ln1"], x), ctx, cfg,
                       causal=causal, window=cfg.swa_window)
    x = x + h
    y = norm_apply("rms", p["ln2"], x).to(ctx.compute_dtype)
    m = (moe_apply(p["mlp"], y, cfg, ctx, sp=True) if cfg.moe
         else mlp_apply(p["mlp"], y, cfg, ctx, sp=True))
    return x + m


def _rwkv_block_apply(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    x = x + rk.timemix_apply(p["tm"], norm_apply("layer", p["ln1"], x), ctx,
                             cfg)
    return x + rk.chanmix_apply(p["cm"], norm_apply("layer", p["ln2"], x),
                                ctx, cfg)


def _mamba_block_apply(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    return x + sm.mamba_apply(p["mamba"], norm_apply("rms", p["ln"], x), ctx,
                              cfg)


def _cross_block_apply(p: dict, x: torch.Tensor, img_kv, ctx,
                       cfg) -> torch.Tensor:
    """The llama-3.2-style gated cross-attention layer: ``x + tanh(xgate)
    * xattn(x)``, then ``+ tanh(mgate) * mlp``."""
    h = cross_attention(p["xattn"], norm_apply("rms", p["xln"], x), img_kv,
                        ctx, cfg)
    x = x + _gate(p["xgate"], h, ctx) * h
    m = mlp_apply(p["mlp"], norm_apply("rms", p["ln2"], x).to(
        ctx.compute_dtype), cfg, ctx, sp=True)
    return x + _gate(p["mgate"], m, ctx) * m


def _gate(g: torch.Tensor, h: torch.Tensor, ctx) -> torch.Tensor:
    """``tanh`` of a cross layer's gate (1,) — every PE's copy (tp, 1) at
    tp > 1 — in h's dtype, broadcasting against h."""
    return torch.tanh(pe_vec(g, h, tp_of(ctx)).to(h.dtype))


def per_pe(x: torch.Tensor, ctx) -> torch.Tensor:
    """Batch data the same on every PE (the vlm's image embeddings,
    whisper's frames) as every PE's copy (tp, ...) at tp > 1."""
    tp = tp_of(ctx)
    return x.expand((tp,) + tuple(x.shape)) if tp > 1 else x


def _run(blocks, lo: int, hi: int, x, fn, ctx, cfg, *extra):
    """Layers ``lo .. hi-1`` of a group, ``fn(p, x, ctx, cfg, *extra)``
    each, under ``torch.utils.checkpoint`` when ``ctx.remat`` (the
    reference's checkpointed ``_scan`` body)."""
    for li in range(lo, hi):
        p = layer(blocks, li)
        x = (checkpoint(fn, p, x, ctx, cfg, *extra, use_reentrant=False)
             if ctx.remat else fn(p, x, ctx, cfg, *extra))
    return x


def _need_img(cfg, img_embeds) -> None:
    if cfg.family == "vlm" and img_embeds is None:
        raise ValueError(f"{cfg.name}: the vlm's forward needs img_embeds "
                         f"(b, img_tokens={cfg.img_tokens}, "
                         f"d_model={cfg.d_model}), batch['img_embeds'] in "
                         f"training")


def _embed_sp(params: dict, ids: torch.Tensor, ctx) -> torch.Tensor:
    """ids (b, t), the same on every PE -> the embedding rows, at tp > 1
    sequence-sharded (tp, b, t/tp, d): each vocab shard's partial rows
    for every token, reduced and scattered over the sequence in one
    ``sp_scatter``, the reference's ``_embed_sp``."""
    if tp_of(ctx) == 1:
        return embed_lookup(params["embed"], ids, ctx.compute_dtype)
    return sp_scatter(embed_lookup(params["embed"], ids, ctx.compute_dtype,
                                   ctx, reduce=False), ctx)


def forward(params: dict, ids: torch.Tensor, ctx, cfg,
            img_embeds=None) -> torch.Tensor:
    """ids (b, t) -> final hidden states (b, t, d); at tp > 1 each PE's
    sequence shard (tp, b, t/tp, d) (module docstring).  With
    ``ctx.remat``
    each stacked layer runs under ``torch.utils.checkpoint`` — its
    activations are recomputed in the backward, as the reference's
    checkpointed ``_scan`` body — so its forward runs twice per step.
    The hybrid's shared block and the vlm's cross layers (with their
    ``cross_kv``) run outside the scans in the reference, unchecked, and
    so here: once a group."""
    fam = cfg.family
    if fam not in FAMILIES:
        _refuse(cfg, "runs the forward of")
    _need_img(cfg, img_embeds)
    x = _embed_sp(params, ids, ctx)
    blocks = params["blocks"]
    if fam in ("dense", "moe"):
        x = _run(blocks, 0, n_blocks(blocks), x, _dense_block_apply, ctx,
                 cfg)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        for g in range(cfg.n_layers // k):
            x = _run(blocks, g * (k - 1), (g + 1) * (k - 1), x,
                     _dense_block_apply, ctx, cfg)
            cg = layer(params["cross"], g)
            kv = cross_kv(cg["xattn"], per_pe(img_embeds, ctx), ctx, cfg)
            x = _cross_block_apply(cg, x, kv, ctx, cfg)
    elif fam == "ssm":
        x = _run(blocks, 0, n_blocks(blocks), x, _rwkv_block_apply, ctx, cfg)
    else:
        k = cfg.shared_attn_every
        for g in range(n_blocks(blocks) // k):
            x = _run(blocks, g * k, (g + 1) * k, x, _mamba_block_apply, ctx,
                     cfg)
            x = _dense_block_apply(params["shared"], x, ctx, cfg)
        if "tail" in params:
            x = _run(params["tail"], 0, n_blocks(params["tail"]), x,
                     _mamba_block_apply, ctx, cfg)
    return norm_apply("rms", params["ln_f"], x)


def loss_fn(params: dict, batch: dict, ctx, cfg,
            for_grad: bool = False) -> torch.Tensor:
    """batch {'tokens': (b, t+1)} (and for the vlm 'img_embeds' (b,
    img_tokens, d)) -> mean next-token CE.  The head is the embedding
    table when ``cfg.tie_embeddings``.  The loss of one DP
    replica's rows: the train step takes the reference's display value,
    the DP mean, through ``dp_comm``.  At tp > 1 every PE's loss (tp,),
    and with ``for_grad`` the single-seed loss, masked to TP rank 0, as
    the reference's (its gradient is the sum's: ``train.grad.backward``
    seeds every PE with one); at tp = 1 the mask is the identity."""
    tokens = batch["tokens"]
    ids, targets = tokens[:, :-1], tokens[:, 1:]
    x = forward(params, ids, ctx, cfg, img_embeds=batch.get("img_embeds"))
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    loss = lm_head_loss(head, x, targets, ctx)
    if for_grad and tp_of(ctx) > 1:
        loss = torch.where(ctx.tp_rank(loss.device) == 0, loss,
                           torch.zeros_like(loss))
    return loss


def _decode_mlp(p: dict, x: torch.Tensor, cfg, ctx=None,
                replicas: int = 1) -> torch.Tensor:
    """Single-token MLP or MoE: x (b, d) -> (b, d); the MoE routes the b
    slots together, as one window of b tokens (each replica's slots on
    their own).  At tp > 1 x is (tp, b, d) and the MLP ends in its
    psum."""
    if cfg.moe:
        return moe_apply(p, x[..., None, :], cfg, ctx, replicas)[..., 0, :]
    return mlp_apply(p, x, cfg, ctx)


# ======================================================================
# serving: the contiguous-cache decode and prefill
# ======================================================================
def _zeros_stack(one: dict, n: int) -> dict:
    """``n`` zero copies of a state dict, stacked on a leading axis."""
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in one.items()}


def init_decode_state(cfg, ctx, batch: int, max_len: int,
                      device=None) -> dict:
    """The reference's decode state for ``batch`` rows: ``{"cache": each
    layer's state stacked, "pos": 0}``, and for the hybrid
    ``"shared_cache"`` (one cache for every application of the shared
    block) and, with a tail, ``"tail_cache"``, for the vlm
    ``"cross_cache"`` (the reference's ng caches, never read); on
    ``device`` (None: the GPU).  At tp > 1 each layer's state is every
    PE's, (L, tp, b, ...): its KV heads or its cache rows
    (``attention.init_cache``), its RWKV or SSD heads."""
    fam = cfg.family
    device = resolve(device)
    tp = tp_of(ctx)
    lead = (tp, batch) if tp > 1 else (batch,)
    if fam in ("dense", "moe"):
        one = init_cache(cfg, batch, max_len, device=device, ctx=ctx)
        return {"cache": _zeros_stack(one, cfg.n_layers), "pos": 0}
    if fam == "vlm":
        k = cfg.cross_attn_every
        ng = cfg.n_layers // k
        one = init_cache(cfg, batch, max_len, device=device, ctx=ctx)
        return {"cache": _zeros_stack(one, ng * (k - 1)),
                "cross_cache": _zeros_stack(one, ng), "pos": 0}
    if fam == "ssm":
        d, dh = cfg.d_model, cfg.rwkv_head_dim
        f32 = torch.float32
        one = {"S": torch.zeros(lead + (rk._hp(cfg) // tp, dh, dh),
                                dtype=f32, device=device),
               "x_prev_tm": torch.zeros(lead + (d,), dtype=f32,
                                        device=device),
               "x_prev_cm": torch.zeros(lead + (d,), dtype=f32,
                                        device=device)}
        return {"cache": _zeros_stack(one, cfg.n_layers), "pos": 0}
    if fam == "hybrid":
        k = cfg.shared_attn_every
        ng, rem = divmod(cfg.n_layers, k)
        one = sm.mamba_init_state(cfg, batch, device=device, ctx=ctx)
        st = {"cache": _zeros_stack(one, ng * k),
              "shared_cache": init_cache(cfg, batch, max_len, device=device,
                                         ctx=ctx),
              "pos": 0}
        if rem:
            st["tail_cache"] = _zeros_stack(one, rem)
        return st
    _refuse(cfg, "decodes")


def _set(dst: dict, src: dict) -> None:
    """Copy a layer's new state into its views of the stacked state."""
    for k, v in src.items():
        if v is not dst[k]:
            dst[k].copy_(v)


def _decode_dense_block(p: dict, x: torch.Tensor, cache: dict, pos: int,
                        ctx, cfg):
    h, cache = decode_self_attention(p["attn"], norm_apply("rms", p["ln1"], x),
                                     cache, pos, ctx, cfg)
    x = x + h
    return x + _decode_mlp(p["mlp"], norm_apply("rms", p["ln2"], x), cfg,
                           ctx), cache


def _decode_rwkv_block(p: dict, h: torch.Tensor, cache: dict, ctx, cfg):
    hin = norm_apply("layer", p["ln1"], h)
    o, tm = rk.timemix_decode(p["tm"], hin, {"S": cache["S"],
                                             "x_prev": cache["x_prev_tm"]},
                              ctx, cfg)
    h = h + o
    hin2 = norm_apply("layer", p["ln2"], h)
    o2, cm = rk.chanmix_decode(p["cm"], hin2, {"x_prev": cache["x_prev_cm"]},
                               ctx, cfg)
    _set(cache, {"S": tm["S"], "x_prev_tm": tm["x_prev"],
                 "x_prev_cm": cm["x_prev"]})
    return h + o2


def _decode_mamba_group(blocks, cache: dict, lo: int, hi: int, x, ctx, cfg):
    for li in range(lo, hi):
        p = layer(blocks, li)
        c = {k: v[li] for k, v in cache.items()}
        o, nc = sm.mamba_decode(p["mamba"], norm_apply("rms", p["ln"], x), c,
                                ctx, cfg)
        _set(c, nc)
        x = x + o
    return x


def _decode_cross_block(p: dict, x: torch.Tensor, kv, ctx, cfg):
    h = decode_cross_attention(p["xattn"], norm_apply("rms", p["xln"], x),
                               kv, ctx, cfg)
    x = x + _gate(p["xgate"], h, ctx) * h
    m = _decode_mlp(p["mlp"], norm_apply("rms", p["ln2"], x), cfg, ctx)
    return x + _gate(p["mgate"], m, ctx) * m


def decode_logits(params: dict, token: torch.Tensor, state: dict, ctx,
                  cfg, img_kv=None):
    """One serve step: token (b,) (or ``decode_step``'s (tp, b)) -> (logits
    (b, V) in the compute dtype,
    state), the state updated in place (``pos`` advanced).  The step of
    ``decode_step`` before its greedy pick.  The vlm takes ``img_kv``:
    (k, v), each (ng, b, S, H_kv, dh), group g's ``cross_kv`` of the
    image embeddings (at tp > 1 every PE's, (ng, tp, b, S, kvpr, dh)).
    At tp > 1 the logits are each PE's vocab shard, (tp, b, V/tp)."""
    fam = cfg.family
    if fam not in FAMILIES:
        _refuse(cfg, "decodes")
    if fam == "vlm" and img_kv is None:
        raise ValueError("vlm decode_step requires img_kv (precomputed "
                         "per-cross-layer image KV)")
    if token.dim() == 2:              # every PE's pick: the same on each
        token = token[0]
    x = embed_lookup(params["embed"], token[:, None], ctx.compute_dtype,
                     ctx)[..., 0, :]
    pos = state["pos"]
    cache = state["cache"]
    if fam in ("dense", "moe"):
        blocks = params["blocks"]
        for li in range(n_blocks(blocks)):
            x, _ = _decode_dense_block(layer(blocks, li), x,
                                       {k: v[li] for k, v in cache.items()},
                                       pos, ctx, cfg)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        blocks = params["blocks"]
        for g in range(cfg.n_layers // k):
            for li in range(g * (k - 1), (g + 1) * (k - 1)):
                x, _ = _decode_dense_block(
                    layer(blocks, li), x,
                    {kk: v[li] for kk, v in cache.items()}, pos, ctx, cfg)
            x = _decode_cross_block(layer(params["cross"], g), x,
                                    tree_map(lambda a: a[g], img_kv), ctx,
                                    cfg)
    elif fam == "ssm":
        blocks = params["blocks"]
        for li in range(n_blocks(blocks)):
            x = _decode_rwkv_block(layer(blocks, li), x,
                                   {k: v[li] for k, v in cache.items()},
                                   ctx, cfg)
    else:
        k = cfg.shared_attn_every
        blocks = params["blocks"]
        for g in range(n_blocks(blocks) // k):
            x = _decode_mamba_group(blocks, cache, g * k, (g + 1) * k, x,
                                    ctx, cfg)
            # one cache for every application, as the reference threads it
            x, _ = _decode_dense_block(params["shared"], x,
                                       state["shared_cache"], pos, ctx, cfg)
        if "tail" in params:
            x = _decode_mamba_group(params["tail"], state["tail_cache"], 0,
                                    n_blocks(params["tail"]), x, ctx, cfg)
    x = norm_apply("rms", params["ln_f"], x)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = lm_head_logits(head, x.to(ctx.compute_dtype), ctx)
    state["pos"] = pos + 1
    return logits, state


def decode_step(params: dict, token: torch.Tensor, state: dict, ctx, cfg,
                img_kv=None):
    """token (b,) -> (next token (b,) int32, greedy, ties to the lowest
    index; the state, updated in place).  At tp > 1 every PE's pick (tp,
    b), the same on every PE (``tp_argmax`` merges the vocab shards)."""
    logits, state = decode_logits(params, token, state, ctx, cfg, img_kv)
    return tp_argmax(logits, ctx), state


def prefill(params: dict, ids: torch.Tensor, ctx, cfg,
            img_embeds=None) -> torch.Tensor:
    """The full-sequence forward for serving: the last position's hidden
    state (b, d), as the reference's ``prefill`` (the decode cache is not
    built from it there either); at tp > 1 every PE's copy, (tp, b, d),
    after ``sp_gather``."""
    x = sp_gather(forward(params, ids, ctx, cfg, img_embeds=img_embeds),
                  ctx)
    return x[..., -1, :]
