"""Whisper-style encoder-decoder: parameters, the encoder, the
teacher-forced decoder, the loss and the contiguous-cache decode.

The counterpart of ``repro.models.encdec``.  The conv frontend
is a stub there and here: the encoder takes precomputed frame embeddings
``frames`` (b, n_frames, d).  Sinusoidal positions on the encoder
(``_sinusoid``, f32 as the reference computes it), a learned table
``pos_dec`` of ``max_seq * 16`` rows on the decoder, layer norms, GELU
MLPs, no rope.  There is no ``head``: the loss and the logits read the
embedding table, as the reference's do.

The tree: ``embed``, ``pos_dec``, ``enc_blocks`` (``ln1``, ``attn``,
``ln2``, ``mlp``) and ``dec_blocks`` (``ln1``, ``attn``, ``lnx``,
``xattn``, ``ln2``, ``mlp``), each stacked on a leading layer axis (or,
after ``lm.unstack``, per-layer lists), ``ln_enc`` and ``ln_f``.  Under
``ctx.remat`` each encoder and decoder layer runs under
``torch.utils.checkpoint``, as the reference's checkpointed ``_scan``
body: a decoder layer's cross K/V projection is inside it, so the
backward recomputes it too.

Decode: ``encode`` the frames once, ``encoder_cross_kv`` gives every
decoder layer's cross K/V stacked ``(L, b, S, H_kv, dh)``, then
``decode_step`` a token at a time against the bf16 self-attention caches
of ``init_decode_state``; the position reads ``pos_dec[min(pos, rows -
1)]``, the reference's clamp.

At tp > 1 (``weights.shard_for_tp``'s stacked layout) the encoder runs
with sequence parallelism off (``ctx.with_(sp=False)``): every PE holds
all the frames, the head layout psums its partial sums and the ctx
layout attends the whole sequence on every PE (1500 frames do not divide
by 16).  The decoder runs sequence-parallel: the embedding's partial
rows reduce-scattered over the sequence, each PE's positions
``pos_dec[rank * t/tp ..]``, its cross attention reading every PE's copy
of the encoder output.  The loss is masked to TP rank 0 for the
gradient, as ``lm.loss_fn``'s; the decode psums, and picks the token
over the vocab shards (``tp_argmax``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.parallel.ctx import sp_scatter, tp_of

from .attention import (cross_attention, cross_kv, decode_cross_attention,
                        decode_self_attention, init_cache, self_attention)
from .common import ninit, norm_apply, norm_init
from .embed import embed_lookup, lm_head_logits, lm_head_loss, tp_argmax
from .lm import (ACTS, _run, _stack, _zeros_stack, attn_shapes, draw,
                 layer, mlp_shapes, n_blocks, per_pe)
from .mlp import mlp_apply


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: ``[sin(pos / 10000^(2i/d)), cos(...)]``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {"ln1": norm_init("layer", d, dtype, device),
            "attn": draw(attn_shapes(cfg), gen, dtype, device),
            "ln2": norm_init("layer", d, dtype, device),
            "mlp": draw(mlp_shapes(cfg), gen, dtype, device)}


def _dec_block_init(gen, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {"ln1": norm_init("layer", d, dtype, device),
            "attn": draw(attn_shapes(cfg), gen, dtype, device),
            "lnx": norm_init("layer", d, dtype, device),
            "xattn": draw(attn_shapes(cfg), gen, dtype, device),
            "ln2": norm_init("layer", d, dtype, device),
            "mlp": draw(mlp_shapes(cfg), gen, dtype, device)}


def init(gen: torch.Generator, cfg, *, dtype=torch.float32,
         device=None, tp: int = 1) -> dict:
    """Parameters drawn from ``gen`` with ``lm.init``'s distributions
    (``pos_dec`` normal at scale 0.01, as the reference's), the vocab
    table padded to a multiple of ``tp`` rows."""
    if cfg.act not in ACTS:
        raise NotImplementedError(f"act {cfg.act!r} not ported")
    v, d = cfg.padded_vocab(tp), cfg.d_model
    return {
        "embed": {"table": ninit(gen, (v, d), scale=0.02, dtype=dtype,
                                 device=device)},
        "pos_dec": ninit(gen, (cfg.max_seq * 16, d), scale=0.01,
                         dtype=dtype, device=device),
        "enc_blocks": _stack(
            cfg.enc_layers, lambda: _enc_block_init(gen, cfg, dtype, device),
            dtype, device),
        "ln_enc": norm_init("layer", d, dtype, device),
        "dec_blocks": _stack(
            cfg.n_layers, lambda: _dec_block_init(gen, cfg, dtype, device),
            dtype, device),
        "ln_f": norm_init("layer", d, dtype, device),
    }


# ======================================================================
# encoder, teacher-forced decoder, loss
# ======================================================================
def _mlp(p: dict, x: torch.Tensor, ctx, cfg, sp: bool = True) -> torch.Tensor:
    """The MLP; at tp > 1 sequence-parallel in training (``sp``, which
    ``ctx.sp`` off turns into a psum) and psummed in the decode."""
    return mlp_apply(p, x.to(ctx.compute_dtype), cfg, ctx, sp=sp)


def _enc_block_apply(p: dict, h: torch.Tensor, ctx, cfg) -> torch.Tensor:
    h = h + self_attention(p["attn"], norm_apply("layer", p["ln1"], h), ctx,
                           cfg, causal=False)
    return h + _mlp(p["mlp"], norm_apply("layer", p["ln2"], h), ctx, cfg)


def _dec_block_apply(p: dict, h: torch.Tensor, ctx, cfg,
                     enc_out: torch.Tensor) -> torch.Tensor:
    h = h + self_attention(p["attn"], norm_apply("layer", p["ln1"], h), ctx,
                           cfg, causal=True)
    kv = cross_kv(p["xattn"], enc_out, ctx, cfg)
    h = h + cross_attention(p["xattn"], norm_apply("layer", p["lnx"], h), kv,
                            ctx, cfg)
    return h + _mlp(p["mlp"], norm_apply("layer", p["ln2"], h), ctx, cfg)


def encode(params: dict, frames: torch.Tensor, ctx, cfg) -> torch.Tensor:
    """frames (b, n_frames, d) stub embeddings -> (b, n_frames, d):
    sinusoid positions, non-causal self attention, the final layer
    norm.  At tp > 1 every PE's copy (tp, b, n_frames, d), sequence
    parallelism off."""
    cd = ctx.compute_dtype
    x = per_pe(frames, ctx).to(cd) + _sinusoid(
        frames.shape[1], cfg.d_model, frames.device).to(cd)
    blocks = params["enc_blocks"]
    x = _run(blocks, 0, n_blocks(blocks), x, _enc_block_apply,
             ctx.with_(sp=False), cfg)
    return norm_apply("layer", params["ln_enc"], x)


def decode_train(params: dict, ids: torch.Tensor, enc_out: torch.Tensor,
                 ctx, cfg) -> torch.Tensor:
    """Teacher-forced decoder: ids (b, t) -> final hidden states (b, t,
    d); positions ``pos_dec[0 .. t-1]``, causal self attention, cross
    attention to ``enc_out``.  At tp > 1 each PE's sequence shard (tp, b,
    t/tp, d) at positions ``rank * t/tp ..`` (module docstring)."""
    cd, table = ctx.compute_dtype, params["pos_dec"]
    if tp_of(ctx) > 1:
        x = sp_scatter(embed_lookup(params["embed"], ids, cd, ctx,
                                    reduce=False), ctx)
        tp, tl = x.shape[0], x.shape[2]
        pe = torch.arange(tp, device=x.device)
        rows = (pe * tl if ctx.sp else 0 * pe)[:, None] + \
            torch.arange(tl, device=x.device)
        x = x + table[pe[:, None], rows].to(x.dtype)[:, None]
    else:
        x = embed_lookup(params["embed"], ids, cd)
        x = x + table[:x.shape[1]].to(x.dtype)[None]
    blocks = params["dec_blocks"]
    x = _run(blocks, 0, n_blocks(blocks), x, _dec_block_apply, ctx, cfg,
             enc_out)
    return norm_apply("layer", params["ln_f"], x)


def loss_fn(params: dict, batch: dict, ctx, cfg,
            for_grad: bool = False) -> torch.Tensor:
    """batch {'frames': (b, n_frames, d), 'tokens': (b, t+1)} -> mean
    next-token CE over the embedding table; at tp > 1 every PE's loss
    (tp,), with ``for_grad`` masked to TP rank 0, as ``lm.loss_fn``'s."""
    if "frames" not in batch:
        raise ValueError(f"{cfg.name}: the encoder-decoder loss needs "
                         f"batch['frames'] (b, enc_frames={cfg.enc_frames}, "
                         f"d_model={cfg.d_model}) beside batch['tokens']")
    tokens = batch["tokens"]
    ids, targets = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(params, batch["frames"], ctx, cfg)
    x = decode_train(params, ids, enc_out, ctx, cfg)
    loss = lm_head_loss(params["embed"], x, targets, ctx)
    if for_grad and tp_of(ctx) > 1:
        loss = torch.where(ctx.tp_rank(loss.device) == 0, loss,
                           torch.zeros_like(loss))
    return loss


# ======================================================================
# decode
# ======================================================================
def init_decode_state(cfg, ctx, batch: int, max_len: int,
                      device=None) -> dict:
    """``{"cache": n_layers bf16 self-attention caches stacked, "pos":
    0}`` on ``device`` (None: the GPU); at tp > 1 every PE's
    (``attention.init_cache``)."""
    one = init_cache(cfg, batch, max_len, device=resolve(device), ctx=ctx)
    return {"cache": _zeros_stack(one, cfg.n_layers), "pos": 0}


def encoder_cross_kv(params: dict, enc_out: torch.Tensor, ctx, cfg):
    """Every decoder layer's cross K/V of ``enc_out``: (k, v), each (L,
    b, S, H_kv, dh); at tp > 1, of every PE's copy of it, (L, tp, b, S,
    kvpr, dh) (all the KV heads in the ctx layout)."""
    blocks = params["dec_blocks"]
    kvs = [cross_kv(layer(blocks, li)["xattn"], enc_out, ctx, cfg)
           for li in range(n_blocks(blocks))]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def decode_logits(params: dict, token: torch.Tensor, state: dict, enc_kv,
                  ctx, cfg):
    """One step: token (b,) (or ``decode_step``'s (tp, b)) -> (logits (b,
    V) in the compute dtype, state), the caches written in place and
    ``pos`` advanced.  ``enc_kv`` is ``encoder_cross_kv``'s.  At tp > 1
    the logits are each PE's vocab shard, (tp, b, V/tp)."""
    if token.dim() == 2:              # every PE's pick: the same on each
        token = token[0]
    x = embed_lookup(params["embed"], token[:, None], ctx.compute_dtype,
                     ctx)[..., 0, :]
    pos = state["pos"]
    table = params["pos_dec"]
    row = table[..., min(pos, table.shape[-2] - 1), :]
    x = x + row.to(x.dtype)[..., None, :]
    blocks, cache = params["dec_blocks"], state["cache"]
    ek, ev = enc_kv
    for li in range(n_blocks(blocks)):
        p = layer(blocks, li)
        a, _ = decode_self_attention(
            p["attn"], norm_apply("layer", p["ln1"], x),
            {k: v[li] for k, v in cache.items()}, pos, ctx, cfg)
        x = x + a
        x = x + decode_cross_attention(
            p["xattn"], norm_apply("layer", p["lnx"], x), (ek[li], ev[li]),
            ctx, cfg)
        x = x + _mlp(p["mlp"], norm_apply("layer", p["ln2"], x), ctx, cfg,
                     sp=False)
    x = norm_apply("layer", params["ln_f"], x)
    logits = lm_head_logits(params["embed"], x.to(ctx.compute_dtype), ctx)
    state["pos"] = pos + 1
    return logits, state


def decode_step(params: dict, token: torch.Tensor, state: dict, enc_kv,
                ctx, cfg):
    """token (b,) -> (next token (b,) int32, greedy; the state, updated in
    place); at tp > 1 every PE's pick (tp, b)."""
    logits, state = decode_logits(params, token, state, enc_kv, ctx, cfg)
    return tp_argmax(logits, ctx), state
