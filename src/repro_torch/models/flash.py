"""Blocked online-softmax attention with a FlashAttention-2 backward.

The counterpart of ``repro.models.flash.blocked_attention`` and its
custom-VJP ``_flash_chunk``, here a ``torch.autograd.Function``:

  * forward, ``impl="kernel"`` on a CUDA tensor: ONE launch of the
    flash kernel (``repro_torch.kernels.flash_attention``) over the whole
    query range — the hardware path the reference's docstring names
    ("used when ctx.use_pallas on hardware").  It returns the output and
    the rows' log-sum-exp.  On a meta tensor (the dry run) the same call
    takes the wrapper's meta route: shapes, dtypes and the kernel's
    operation count, no launch;
  * forward on a CPU tensor, or with ``impl="ref"``: the plain mirror of
    ``_flash_chunk_fwd_impl`` — a Python loop over query chunks of
    ``block_q`` rows, each over the KV prefix a causal chunk can see, in
    KV blocks of ``block_kv`` with the online softmax;
  * backward (both): the blocked recompute of ``_flash_chunk_bwd`` in
    plain PyTorch, walking (query chunk x KV block) pairs and skipping
    the pairs outside the causal or window range (their probabilities
    are exactly zero).  The JAX package has no backward kernel either.

Layout as in the reference: q (b, t, h, dh), k/v (b, s, h_kv, dh), GQA
groups explicit inside (b, t, h_kv, g, dh), no K/V repetition.
``q_offset`` (a Python int here) is the position of query row 0 and
``kv_len`` masks the KV columns at and past it.  ``pe_rows`` and
``pe_stride`` give every batch row its own offset, ``q_offset + (b //
pe_rows) * pe_stride`` (``kernels.flash_attention.query_positions``):
the ctx attention layout folds every PE's rows into the batch, PE
``r``'s queries at ``r * t/tp`` of the gathered K/V, in ONE launch; the
plain forward and the backward mask each row by its own position and
skip only the pairs no PE's rows can see.

The contiguous-cache decode path's attention is here too, as plain f32
PyTorch, as the reference's is jnp: ``decode_attention`` (one token
against a cache, with the ``window``/``pos`` mask), and for a cache
split over ranks ``decode_attention_partial`` and ``flash_combine``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa

NEG, BIG = fa.NEG_INF, fa.BIG
IMPLS = ("kernel", "ref")
_mask = fa.attention_mask


def _rows(q_offset, tq, b, pe, device):
    """The query positions of a chunk, (tq,) or per batch row (b, tq)."""
    return fa.query_positions(q_offset, tq, device, b, *pe)


def _pe_mask(msk, pe):
    """A per-row mask (b, i, j) against scores (b, hkv, g, i, j)."""
    return msk[:, None, None] if pe[1] else msk


def _chunk_fwd(q, k, v, scale, causal, window, kv_len, block_kv, q_offset,
               pe=(1, 0)):
    """Plain mirror of ``_flash_chunk_fwd_impl``.  q (b, tq, hkv, g, dh);
    k, v (b, s, hkv, dh) -> out like q, lse (b, hkv, g, tq) f32.  The last
    KV block is ragged instead of padded: its padded columns were masked.
    ``pe`` = (pe_rows, pe_stride), each batch row's offset."""
    b, tq, hkv, g, dh = q.shape
    s = k.shape[1]
    rows = _rows(q_offset, tq, b, pe, q.device)
    qf = q.float()
    m = torch.full((b, hkv, g, tq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, tq, dh), dtype=torch.float32,
                      device=q.device)
    for j in range(0, s, block_kv):
        kj, vj = k[:, j:j + block_kv].float(), v[:, j:j + block_kv].float()
        cols = j + torch.arange(kj.shape[1], device=q.device)
        sc = torch.einsum("bihgd,bjhd->bhgij", qf, kj) * scale
        msk = _pe_mask(_mask(rows, cols, causal, window, kv_len), pe)
        sc = torch.where(msk, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgij,bjhd->bhgid", p, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.movedim(-2, 1).to(q.dtype)            # (b, tq, hkv, g, dh)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, BIG))
    return out, lse


def _pe_span(b, pe_rows, pe_stride) -> int:
    """How far past PE 0's the last PE's queries sit."""
    return (b // pe_rows - 1) * pe_stride


def _forward(q, k, v, scale, causal, window, kv_len, block_q, block_kv,
             q_offset, pe_rows, pe_stride, impl):
    b, tq, hkv, g, dh = q.shape
    if impl == "kernel" and q.device.type in ("cuda", "meta"):
        out, lse = fa.flash_attention(
            q.reshape(b, tq, hkv * g, dh).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), causal=causal, window=window, sm_scale=scale,
            q_offset=q_offset, kv_len=kv_len, pe_rows=pe_rows,
            pe_stride=pe_stride)
        return (out.transpose(1, 2).reshape(b, tq, hkv, g, dh),
                lse.reshape(b, hkv, g, tq))
    s = k.shape[1]
    pe, span = (pe_rows, pe_stride), _pe_span(b, pe_rows, pe_stride)
    outs, lses = [], []
    for qs in range(0, tq, block_q):
        qc = q[:, qs:qs + block_q]
        off = q_offset + qs
        if causal:              # the KV prefix this chunk's last PE sees
            hi = min(s, off + span + qc.shape[1])
            nb = max(1, -(-hi // block_kv))
            k_use, v_use = k[:, :nb * block_kv], v[:, :nb * block_kv]
            kl = min(kv_len, k_use.shape[1])
        else:
            k_use, v_use, kl = k, v, kv_len
        o, lse = _chunk_fwd(qc, k_use, v_use, scale, causal, window, kl,
                            block_kv, off, pe)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _backward(q, k, v, out, lse, dout, scale, causal, window, kv_len,
              block_q, block_kv, q_offset, pe_rows, pe_stride):
    """The blocked recompute of ``_flash_chunk_bwd`` over (query chunk x
    KV block) pairs inside the causal / window / kv_len range of any
    PE's rows."""
    b, tq, hkv, g, dh = q.shape
    s = k.shape[1]
    pe, span = (pe_rows, pe_stride), _pe_span(b, pe_rows, pe_stride)
    qf = q.float()
    dof = dout.float().movedim(1, -2)                # (b, hkv, g, tq, dh)
    D = (dof * out.float().movedim(1, -2)).sum(-1)   # (b, hkv, g, tq)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for qs in range(0, tq, block_q):
        qe = min(qs + block_q, tq)
        rows = _rows(q_offset + qs, qe - qs, b, pe, q.device)
        r_lo, r_hi = q_offset + qs, q_offset + span + qe - 1
        qc, doc = qf[:, qs:qe], dof[..., qs:qe, :]
        lse_c, d_c = lse[..., qs:qe, None], D[..., qs:qe, None]
        for ks in range(0, min(s, kv_len), block_kv):
            if causal and ks > r_hi:
                break
            ke = min(ks + block_kv, s)
            if window is not None and ke - 1 <= r_lo - window:
                continue
            kj, vj = k[:, ks:ke].float(), v[:, ks:ke].float()
            cols = torch.arange(ks, ke, device=q.device)
            sc = torch.einsum("bihgd,bjhd->bhgij", qc, kj) * scale
            msk = _pe_mask(_mask(rows, cols, causal, window, kv_len), pe)
            sc = torch.where(msk, sc, torch.full_like(sc, NEG))
            p = torch.exp(sc - lse_c)                # (b, hkv, g, i, j)
            dv[:, ks:ke] += torch.einsum("bhgij,bhgid->bjhd", p, doc)
            dp = torch.einsum("bhgid,bjhd->bhgij", doc, vj)
            ds = p * (dp - d_c) * scale
            dq[:, qs:qe] += torch.einsum("bhgij,bjhd->bihgd", ds, kj)
            dk[:, ks:ke] += torch.einsum("bhgij,bihgd->bjhd", ds, qc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); ``opts`` = (scale, causal, window,
    kv_len, block_q, block_kv, q_offset, pe_rows, pe_stride, impl), all
    static."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        out, lse = _forward(q, k, v, *opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.opts[:-1])
        return dq, dk, dv, None


def blocked_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                      scale: Optional[float] = None, q_offset: int = 0,
                      kv_len: Optional[int] = None, block_q: int = 1024,
                      block_kv: int = 1024, impl: str = "kernel",
                      pe_rows: int = 1, pe_stride: int = 0):
    """q: (b, tq, h, dh); k, v: (b, s, hkv, dh) -> (b, tq, h, dh).
    Batch row ``b``'s queries sit at ``q_offset + (b // pe_rows) *
    pe_stride + i`` (module docstring).

    ``block_q`` / ``block_kv`` are the chunks of the plain forward and of
    the backward (the kernel has its own tiles); ``impl`` is the
    context's ``attn_impl``.  The reference's ``unroll`` (dry-run flop
    accounting of ``lax.scan``) has no counterpart: there is no scan."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl={impl!r} (choose from {IMPLS})")
    b, tq, h, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kv_len = s if kv_len is None else kv_len
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, tq, hkv, h // hkv, dh)
    fa.check_pe(b, pe_rows, pe_stride)
    opts = (scale, causal, window, kv_len, min(block_q, tq), block_kv,
            int(q_offset), int(pe_rows), int(pe_stride), impl)
    return _FlashAttention.apply(qg, k, v, opts).reshape(b, tq, h, dh)


# ======================================================================
# decode against a contiguous cache
# ======================================================================
def decode_attention(q, kcache, vcache, cur_len: int, *,
                     scale: Optional[float] = None,
                     window: Optional[int] = None, pos: Optional[int] = None):
    """One step against a cache: q (b, h, dh); kcache/vcache (b, S, hkv,
    dh); slots ``< cur_len`` valid, and with ``window`` and ``pos`` only
    those ``> pos - window`` too.  Returns (b, h, dh) in q's dtype; the
    scores, softmax and sums in f32, as the reference's
    ``decode_attention``."""
    b, h, dh = q.shape
    s, hkv = kcache.shape[1], kcache.shape[2]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, dh).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qg, kcache.float()) * scale
    idx = torch.arange(s, device=q.device)
    msk = idx < cur_len
    if window is not None and pos is not None:
        msk = msk & (idx > pos - window)
    sc = torch.where(msk, sc, torch.full_like(sc, NEG))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vcache.float())
    return o.reshape(b, h, dh).to(q.dtype)


def decode_attention_partial(q, kcache, vcache, valid_mask, *,
                             scale: Optional[float] = None):
    """A rank's slice of the KV sequence: unnormalised ``(acc (b, hkv, g,
    dh), m (b, hkv, g), l (b, hkv, g))`` for ``flash_combine``.  q (b, h,
    dh); caches (b, s_loc, hkv, dh); valid_mask (b, s_loc) bool."""
    b, h, dh = q.shape
    hkv = kcache.shape[2]
    g = h // hkv
    scale = dh ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, dh).float()
    sc = torch.einsum("bhgd,bshd->bhgs", qg, kcache.float()) * scale
    valid = valid_mask[:, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, NEG))
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    p = torch.where(valid, p, torch.zeros_like(p))
    l = p.sum(-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vcache.float())
    return acc, m, l


def flash_combine(acc, m, l, axis_combine):
    """Combine partial ``(acc, m, l)`` across ranks; ``axis_combine`` is
    ``{"pmax": f, "psum": f}`` from the comm layer (a stacked team's
    reductions over the leading PE axis, or the identity at one rank)."""
    m_glob = axis_combine["pmax"](m)
    corr = torch.exp(m - m_glob)
    l_glob = axis_combine["psum"](l * corr)
    acc_glob = axis_combine["psum"](acc * corr[..., None])
    return acc_glob / l_glob.clamp_min(1e-30)[..., None]
