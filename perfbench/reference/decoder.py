"""The plain reference of a served Qwen3 decoder (dense or MoE): the
forward pass over whole sequences, in float32 with TF32 off, written
from the published architecture (RMS norms, q/k norms, half-split RoPE,
grouped-query causal attention, a SwiGLU MLP or a top-k routed MoE
whose k gates are renormalised, and no capacity: every routed token
reaches its experts, as the published model computes).

It takes the weights from the same seeded draws the benchmark handed to
the program (``lib.weights``), layer by layer, and nothing the program
made.  ``served_gaps`` runs every sequence through each layer in turn
(a layer's weights are drawn once) and reads, at each position where the
program served a token, how far that token's logit lies below the
reference's best.

``control="fp8"`` computes a second stream beside it whose every linear
product takes its operands rounded to float8 e4m3 (a scale per tensor),
the precision below bfloat16, and reads the same gaps for the tokens
that stream puts first: the readings a correct bfloat16 program must
stay well under.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.lib import weights

QUERY_CHUNK = 512


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _mm(x, w, lowp):
    return fp8(x) @ fp8(w) if lowp else x @ w


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (T, heads, dh) at positions 0 .. T-1, halves rotated."""
    t, _, dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(q, k, v):
    """Causal grouped-query attention: q (T, H, dh), k/v (T, Hkv, dh)."""
    t, h, dh = q.shape
    hkv = k.shape[1]
    qg = q.view(t, hkv, h // hkv, dh)
    out = []
    for a in range(0, t, QUERY_CHUNK):
        b = min(t, a + QUERY_CHUNK)
        s = torch.einsum("cngd,snd->ngcs", qg[a:b], k[:b]) / math.sqrt(dh)
        mask = torch.arange(b, device=q.device)[None] > \
            torch.arange(a, b, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), -1)
        out.append(torch.einsum("ngcs,snd->cngd", p, v[:b]).reshape(
            b - a, h, dh))
    return torch.cat(out)


def moe(x, lw, cfg, lowp):
    """Top-k routed experts over tokens x (N, d), every routed pair
    computed, the k gates renormalised to sum one."""
    k = int(cfg["num_experts_per_tok"])
    probs = torch.softmax(_mm(x, lw["router"], lowp), -1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(lw["router"].shape[1]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        y = _mm(F.silu(_mm(xe, lw["wg"][e], lowp)) *
                _mm(xe, lw["wu"][e], lowp), lw["wd"][e], lowp)
        out.index_add_(0, tok, y * gate[tok, slot, None])
    return out


def layer(xs, lw, cfg, lowp):
    """One decoder layer over each sequence's hidden states (T, d)."""
    w = weights.dims(cfg)
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    mid = []
    for x in xs:
        t = x.shape[0]
        h = rms(x, lw["ln1"], eps)
        q = _mm(h, lw["wq"], lowp).view(t, w["h"], w["dh"])
        k = _mm(h, lw["wk"], lowp).view(t, w["hkv"], w["dh"])
        v = _mm(h, lw["wv"], lowp).view(t, w["hkv"], w["dh"])
        q = rope(rms(q, lw["q_norm"], eps), theta)
        k = rope(rms(k, lw["k_norm"], eps), theta)
        o = attention(q, k, v).reshape(t, -1)
        mid.append(x + _mm(o, lw["wo"], lowp))
    hs = [rms(x, lw["ln2"], eps) for x in mid]
    if w["experts"]:
        ys = moe(torch.cat(hs), lw, cfg, lowp).split([len(h) for h in hs])
    else:
        ys = [_mm(F.silu(_mm(h, lw["wg"], lowp)) * _mm(h, lw["wu"], lowp),
                  lw["wd"], lowp) for h in hs]
    return [x + y for x, y in zip(mid, ys)]


@torch.no_grad()
def served_gaps(cfg: dict, seed: int, seqs: list, device,
                control=None) -> dict:
    """``seqs``: (prompt ids, served tokens) pairs.  Returns the gaps
    (reference's best logit minus the served token's) over every served
    position (``gap_stats``: ``max_logit_gap``, ``mean_logit_gap``, ...)
    and ``tokens``, the positions read; with ``control="fp8"`` the same
    of the tokens the float8 stream puts first, prefixed ``control_``."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _gaps(cfg, seed, seqs, device, control == "fp8")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _gaps(cfg, seed, seqs, device, with_control):
    if not seqs:
        return {"max_logit_gap": float("inf"),
                "mean_logit_gap": float("inf"), "tokens": 0}
    dtype = weights.DTYPES[cfg["torch_dtype"]]
    w = weights.dims(cfg)
    ids = [torch.as_tensor(np.concatenate(
        [np.asarray(p, np.int64), np.asarray(o[:-1], np.int64)]),
        device=device) for p, o in seqs]
    embed = weights.table(cfg, seed, "embed", dtype, device).float()
    streams = {False: [embed[i] for i in ids]}
    if with_control:
        streams[True] = [x.clone() for x in streams[False]]
    del embed
    for li in range(w["layers"]):
        lw = {k: t.float()
              for k, t in weights.layer(cfg, seed, li, dtype, device).items()}
        for lowp in streams:
            streams[lowp] = layer(streams[lowp], lw, cfg, lowp)
        del lw
    ln_f = weights.table(cfg, seed, "ln_f", dtype, device).float()
    head = weights.table(cfg, seed, "embed" if weights.tied(cfg) else "head",
                         dtype, device).float()
    eps = float(cfg["rms_norm_eps"])
    gaps, ctl_gaps = [], []
    for i, (p, o) in enumerate(seqs):
        rows = slice(len(p) - 1, len(p) - 1 + len(o))
        logits = rms(streams[False][i][rows], ln_f, eps) @ head.T
        best = logits.amax(-1)
        tok = torch.as_tensor(np.asarray(o, np.int64), device=device)
        gaps.append(best - logits.gather(1, tok[:, None])[:, 0])
        if with_control:
            lc = _mm(rms(streams[True][i][rows], ln_f, eps), head.T, True)
            pick = lc.argmax(-1)
            ctl_gaps.append(best - logits.gather(1, pick[:, None])[:, 0])
    out = {"tokens": int(sum(len(o) for _, o in seqs)),
           **gap_stats(torch.cat(gaps), "")}
    if with_control:
        out.update(gap_stats(torch.cat(ctl_gaps), "control_"))
    return out


def gap_stats(g: torch.Tensor, prefix: str) -> dict:
    """The widest gap, the mean gap, its 90th percentile and the share
    of positions whose token is not the reference's best."""
    return {prefix + "max_logit_gap": float(g.max()),
            prefix + "mean_logit_gap": float(g.mean()),
            prefix + "p90_logit_gap": float(torch.quantile(g, 0.9)),
            prefix + "off_best": float((g > 0).float().mean())}
