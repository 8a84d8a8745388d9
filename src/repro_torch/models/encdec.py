"""Whisper-style encoder-decoder: parameters, the encoder, the
teacher-forced decoder, the loss and the contiguous-cache decode.

The counterpart of ``repro.models.encdec`` at tp = 1.  The conv frontend
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
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve

from .attention import (cross_attention, cross_kv, decode_cross_attention,
                        decode_self_attention, init_cache, self_attention)
from .common import ninit, norm_apply, norm_init
from .embed import embed_lookup, lm_head_logits, lm_head_loss, tp_argmax
from .lm import (ACTS, _check_decode_tp, _run, _stack, _zeros_stack,
                 attn_shapes, draw, layer, mlp_shapes, n_blocks)
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
         device=None) -> dict:
    """Parameters drawn from ``gen`` with ``lm.init``'s distributions
    (``pos_dec`` normal at scale 0.01, as the reference's)."""
    if cfg.act not in ACTS:
        raise NotImplementedError(f"act {cfg.act!r} not ported")
    v, d = cfg.padded_vocab(1), cfg.d_model
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
def _mlp(p: dict, x: torch.Tensor, ctx, cfg) -> torch.Tensor:
    return mlp_apply(p, x.to(ctx.compute_dtype), cfg)


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
    norm."""
    cd = ctx.compute_dtype
    x = frames.to(cd) + _sinusoid(frames.shape[1], cfg.d_model,
                                  frames.device).to(cd)
    blocks = params["enc_blocks"]
    x = _run(blocks, 0, n_blocks(blocks), x, _enc_block_apply, ctx, cfg)
    return norm_apply("layer", params["ln_enc"], x)


def decode_train(params: dict, ids: torch.Tensor, enc_out: torch.Tensor,
                 ctx, cfg) -> torch.Tensor:
    """Teacher-forced decoder: ids (b, t) -> final hidden states (b, t,
    d); positions ``pos_dec[0 .. t-1]``, causal self attention, cross
    attention to ``enc_out``."""
    x = embed_lookup(params["embed"], ids, ctx.compute_dtype)
    x = x + params["pos_dec"][:x.shape[1]].to(x.dtype)[None]
    blocks = params["dec_blocks"]
    x = _run(blocks, 0, n_blocks(blocks), x, _dec_block_apply, ctx, cfg,
             enc_out)
    return norm_apply("layer", params["ln_f"], x)


def loss_fn(params: dict, batch: dict, ctx, cfg,
            for_grad: bool = False) -> torch.Tensor:
    """batch {'frames': (b, n_frames, d), 'tokens': (b, t+1)} -> mean
    next-token CE over the embedding table (``for_grad`` as in
    ``lm.loss_fn``: the identity at tp = 1)."""
    del for_grad
    if "frames" not in batch:
        raise ValueError(f"{cfg.name}: the encoder-decoder loss needs "
                         f"batch['frames'] (b, enc_frames={cfg.enc_frames}, "
                         f"d_model={cfg.d_model}) beside batch['tokens']")
    tokens = batch["tokens"]
    ids, targets = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(params, batch["frames"], ctx, cfg)
    x = decode_train(params, ids, enc_out, ctx, cfg)
    return lm_head_loss(params["embed"], x, targets, ctx)


# ======================================================================
# decode
# ======================================================================
def init_decode_state(cfg, ctx, batch: int, max_len: int,
                      device=None) -> dict:
    """``{"cache": n_layers bf16 self-attention caches stacked, "pos":
    0}`` on ``device`` (None: the GPU)."""
    _check_decode_tp(ctx)
    one = init_cache(cfg, batch, max_len, device=resolve(device))
    return {"cache": _zeros_stack(one, cfg.n_layers), "pos": 0}


def encoder_cross_kv(params: dict, enc_out: torch.Tensor, ctx, cfg):
    """Every decoder layer's cross K/V of ``enc_out``: (k, v), each (L,
    b, S, H_kv, dh)."""
    blocks = params["dec_blocks"]
    kvs = [cross_kv(layer(blocks, li)["xattn"], enc_out, ctx, cfg)
           for li in range(n_blocks(blocks))]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def decode_logits(params: dict, token: torch.Tensor, state: dict, enc_kv,
                  ctx, cfg):
    """One step: token (b,) -> (logits (b, V) in the compute dtype,
    state), the caches written in place and ``pos`` advanced.
    ``enc_kv`` is ``encoder_cross_kv``'s."""
    _check_decode_tp(ctx)
    x = embed_lookup(params["embed"], token[:, None], ctx.compute_dtype)[:, 0]
    pos = state["pos"]
    table = params["pos_dec"]
    x = x + table[min(pos, table.shape[0] - 1)].to(x.dtype)[None]
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
        x = x + _mlp(p["mlp"], norm_apply("layer", p["ln2"], x), ctx, cfg)
    x = norm_apply("layer", params["ln_f"], x)
    logits = lm_head_logits(params["embed"], x.to(ctx.compute_dtype))
    state["pos"] = pos + 1
    return logits, state


def decode_step(params: dict, token: torch.Tensor, state: dict, enc_kv,
                ctx, cfg):
    """token (b,) -> (next token (b,) int32, greedy; the state, updated in
    place)."""
    logits, state = decode_logits(params, token, state, enc_kv, ctx, cfg)
    return tp_argmax(logits), state
