"""Continuous-batching inference engine over the paged symmetric-heap
KV cache — the counterpart of ``repro.serve.engine`` for serving a
dense or MoE decoder, colocated or as one cell of a disaggregated
topology (``serve.disagg``), on one PE or tensor-parallel on the stacked
team (``ctx.tp_size > 1``; a MoE decoder through ``ctx.moe_dispatch``).

Two layers, as in the reference:

  * **step functions** (``make_prefill`` / ``make_decode_step``), built
    from the model functions (``attention.project_qkv``, ``embed``,
    ``mlp``) and a Python loop over layers.  Both read and write K/V
    through the block table — decode through ``ops.paged_attention``,
    the chunked-prefill window through ``ops.paged_prefill_attention``
    — and both end in the sampler (``serve.sampling``), whose draws are
    keyed ``(rid, position)``, so token streams do not depend on batch
    composition or prefill chunking.  A MoE block routes every row of
    the call together (``mlp.moe_apply``), padded and inactive rows
    included, as the reference does: where the expert capacity drops
    tokens, the streams do depend on what shares a step.  With several
    serving replicas folded into the rows (``StackedExec``), each
    replica's rows are routed on their own, as each of the reference's
    data-parallel replicas routes only its own batch.
    ``make_verify`` is the speculative-decoding twin of the prefill
    window: the same trunk over a ``(B, k+1)`` window of the pending
    token plus the proposed drafts, sampling at EVERY row with the
    non-speculative counter keys, so exact prefix-match acceptance
    reproduces the sequential stream (``serve.spec`` holds the
    proposers).
  * a **host-side loop** (``ServeEngine``) that owns the
    ``FCFSScheduler`` and ``PagedKVCache`` and runs each tick's plan:
    migrate (``put_nbi`` per page, ONE ``quiet()`` on a ``CommQueue``),
    chunked prefill, then one decode token — or one verify window — per
    decoding sequence.  With ``ServeConfig.slo`` the scheduler follows
    the SLO policy (``serve.slo``); with ``prefix_keep`` finished
    prompts' full pages stay as a migratable prefix cache.  A
    ``role="prefill"`` engine stops a sequence at its first token and
    parks it on ``handoff_ready``; a ``role="decode"`` engine receives
    sequences through ``adopt_request``.

Tensor parallelism (``ParallelCtx(tp_size=T)``): the step functions
take ``ctx`` and add ``ctx.tp_comm.psum`` after ``wo`` and after the MLP
(and the embedding's), as the reference's, in the compute dtype; a MoE
block psums its routed experts' partials under the einsum dispatch (or
exchanges its buffers by two ``all_to_all`` under ``alltoall``) and its
shared expert apart (``mlp.moe_apply``); the
weights are stacked once
``(T, ...)`` (``weights.shard_for_tp``); activations carry the PE axis
first; the sampler merges the vocab shards' candidates with
``top_k_merge``.  ``StackedExec`` is the substrate: R replicas x T PEs
on the leading axes of one pool, ONE paged-kernel launch a layer for
all of them.

The pool is updated IN PLACE: page writes are ``index_put_`` on the
per-layer view of the pool tensor, where the reference does a
functional ``.at[].set`` and threads the new pool through ``scan``.
The step functions still return the pool, so the host loop reads like the
reference's.

Batch slots are fixed (``ServeConfig.max_batch``): empty slots carry
the null page table and length 0, which zeroes their attention output
and routes their K/V writes to the null page.

Weight hot-swap (``begin_hot_swap``): a ``ckpt.hotswap.WeightStreamer``
advances one put-with-signal batch at the head of each tick and, on
the flip tick, the exec's ``set_params`` swaps in the reassembled
weights before the tick's forwards (``StackedExec`` stacks them for
TP); ``run`` drains an in-flight swap
once the trace is served, and ``metrics()["swap"]`` carries its
accounting.

Not ported yet (raises ``NotImplementedError``): the sliding window
over the paged cache.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt.hotswap import WeightStreamer
from repro_torch.core.heap import SymmetricHeap
from repro_torch.core.ordering import CommQueue, InPlaceTransport
from repro_torch.core.teams import Team
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import embed as emb
from repro_torch.models import lm
from repro_torch.models import mlp as ff
from repro_torch.models.common import rmsnorm
from repro_torch.parallel import ParallelCtx, tp_of
from repro_torch.weights import shard_for_tp

from . import sampling
from .kv_cache import NULL_PAGE, PagedKVCache
from .scheduler import FCFSScheduler, Request
from .slo import PRIORITIES, SLOPolicy


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving shape: page geometry, batch and sequence bounds, prefill
    chunking, attention implementation, precisions, sampler bounds."""

    page_tokens: int = 8
    n_pages: int = 64
    max_batch: int = 4
    max_seq: int = 64                 # prompt + decode budget per seq
    prefill_chunk: int = 8            # prompt tokens per seq per tick
    tick_tokens: int = 0              # shared decode+prefill budget per
                                      # tick (0 -> max_batch + chunk)
    attn_impl: str = "kernel"         # "kernel" | "ref"; governs decode
                                      # AND the prefill window
    dtype: torch.dtype = torch.float32    # compute AND KV pool: the
                                          # kernels take one dtype
    prefix_keep: bool = False         # pin finished prompts' full pages
                                      # as a migratable prefix cache
    sample_candidates: int = 8        # static top-k bound
    sample_seed: int = 0              # RNG stream root for sampling
    spec_k: int = 0                   # draft tokens verified per seq per
                                      # tick (0 = speculation off)
    draft: str = "ngram"              # default proposer when none is
                                      # passed (serve.spec.make_proposer)
    slo: Optional[object] = None      # serve.slo.SLOConfig, or None for
                                      # plain FCFS

    @property
    def table_slots(self) -> int:
        return -(-self.max_seq // self.page_tokens)


def _check_supported(cfg, ctx=None) -> None:
    tp = tp_of(ctx)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"repro_torch.serve drives dense/moe decoders; got {cfg.family}")
    if cfg.attn_layout(tp) != "head":
        raise NotImplementedError(
            "repro_torch.serve requires the head-parallel attention layout "
            f"({cfg.n_heads} heads, tp={tp})")
    if cfg.swa_window is not None:
        raise NotImplementedError("sliding-window + paged cache: not yet")


# ======================================================================
# step functions
# ======================================================================
def _write_pages(pool, li, k, v, page, slot):
    """Write K/V rows into layer ``li`` of the pool, in place:
    ``pool[page, 0|1, li, slot] = k|v``.  ``page``/``slot`` index tensors
    broadcasting to a shape S, k/v of shape S + (kvh, dh).  Inactive
    slots carry the null page, so their rows land in page 0."""
    idx = (page.long(), slot.long())
    pool[:, 0, li].index_put_(idx, k.to(pool.dtype))
    pool[:, 1, li].index_put_(idx, v.to(pool.dtype))


# At tp > 1 the step functions take the stacked pool ``(R, TP, n_pages,
# *page_row)`` (R serving replicas, each a TP group) and host arrays of
# N = R * B rows, replica-major, and activations carry the PE axis
# first: ``(TP, N, ...)``.  The helpers below give the paged kernels ONE
# launch per layer for every PE and replica: the pool's (R, TP, n_pages)
# axes merge into one page axis (a view), the block tables get each
# PE's page offset, and q folds to (TP * N, ...).  At tp = 1 they are
# identities.
def make_kv_cache(cfg, scfg: ServeConfig, ctx=None) -> PagedKVCache:
    """The page geometry one PE holds for ``cfg`` under ``scfg`` at the
    ctx's TP size: its share of the KV heads, ``kv_per_rank(tp)``."""
    tp = tp_of(ctx)
    return PagedKVCache(
        SymmetricHeap(("model",) if tp > 1 else ("data",)),
        n_layers=cfg.n_layers, kv_heads=cfg.kv_per_rank(tp),
        head_dim=cfg.head_dim, n_pages=scfg.n_pages,
        page_tokens=scfg.page_tokens, dtype=scfg.dtype)


def pe_pool(shape, ctx, *, dtype, device, replicas: int = 1):
    """A zero pool of one PE's ``shape`` for every PE of the layout: as
    it is at tp = 1, ``(replicas, TP, *shape)`` at tp > 1."""
    lead = (replicas, ctx.tp_size) if tp_of(ctx) > 1 else ()
    if not lead and replicas != 1:
        raise ValueError(f"{replicas} replicas need the stacked layout")
    return torch.zeros(lead + tuple(shape), dtype=dtype, device=device)


def _pages_view(pool, ctx):
    """The page axis the kernels index, as a view of the pool."""
    return pool if tp_of(ctx) == 1 else pool.flatten(0, 2)


def _pe_pages(pages, pool, ctx):
    """Host page ids (N, ...) -> the kernels' ids, (TP, N, ...) at tp > 1:
    PE (replica r, rank t) adds ``(r * TP + t) * n_pages``, so each PE's
    page 0 stays its own null page."""
    if tp_of(ctx) == 1:
        return pages
    reps, tp, n_pages = pool.shape[:3]
    ar = lambda n: torch.arange(n, dtype=pages.dtype,     # noqa: E731
                                device=pages.device)
    r = ar(reps).repeat_interleave(pages.shape[0] // reps)
    off = (r[None] * tp + ar(tp)[:, None]) * n_pages        # (TP, N)
    return pages[None] + off.view(off.shape + (1,) * (pages.dim() - 1))


def _fold(x, ctx):
    """(TP, N, ...) -> (TP * N, ...), contiguous (the kernels' rows)."""
    return x if tp_of(ctx) == 1 else x.flatten(0, 1).contiguous()


def _unfold(x, ctx):
    return x if tp_of(ctx) == 1 else x.unflatten(0, (ctx.tp_size, -1))


def _rep(v, ctx):
    """A per-row vector (N,) for every PE's rows, (TP * N,)."""
    return v if tp_of(ctx) == 1 else v.repeat(ctx.tp_size)


def _psum(x, ctx):
    return x if tp_of(ctx) == 1 else ctx.tp_comm.psum(x)


def _make_decode_forward(cfg, scfg: ServeConfig, ctx=None, replicas=1):
    """The decode trunk: (params, pool, tokens, pos, bt, lens) -> (x,
    pool), ``x`` (b, d_model) the final-norm hidden state of each slot's
    token ((TP, N, d_model) at tp > 1, N = ``replicas`` x B rows).

    tokens (b,) input token per slot; pos (b,) its position; bt
    (b, table_slots) int32 block tables; lens (b,) int32 valid tokens
    AFTER this write (pos+1 for live slots, 0 for empty ones)."""
    _check_supported(cfg, ctx)
    P = scfg.page_tokens
    cd = scfg.dtype

    def forward(params, pool, tokens, pos, bt, lens):
        x = emb.embed_lookup(params["embed"], tokens[:, None], cd,
                             ctx)[..., 0, :]
        page = bt.gather(1, (pos // P)[:, None].long())[:, 0]
        slot = pos % P
        kv = _pages_view(pool, ctx)
        wpage = _pe_pages(page, pool, ctx)
        bt_k = _fold(_pe_pages(bt, pool, ctx), ctx)
        lens_k = _rep(lens, ctx)
        for li in range(cfg.n_layers):
            p = lm.layer(params["blocks"], li)
            h = rmsnorm(p["ln1"]["scale"], x).to(cd)
            q, k, v = attn.project_qkv(p["attn"], h[..., None, :],
                                       pos[:, None], cfg, ctx)
            _write_pages(kv, li, k[..., 0, :, :], v[..., 0, :, :], wpage,
                         slot)
            o = ops.paged_attention(_fold(q[..., 0, :, :], ctx), kv[:, 0, li],
                                    kv[:, 1, li], bt_k, lens_k,
                                    impl=scfg.attn_impl)
            x = x + _psum(attn.out_proj(_unfold(o, ctx).to(cd),
                                        p["attn"]["wo"], ctx), ctx)
            x = x + lm._decode_mlp(p["mlp"], rmsnorm(p["ln2"]["scale"], x),
                                   cfg, ctx, replicas)
        return rmsnorm(params["ln_f"]["scale"], x), pool

    return forward


def _head(params, cfg):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def make_decode_step(cfg, scfg: ServeConfig, *, ctx=None, replicas=1):
    """One decode tick: (params, pool, tokens, pos, bt, lens, samp) ->
    (next_tokens, pool): the decode trunk, then the sampler (``samp``
    the ``sampling.batch_state`` arrays).  ``ctx`` (default: tp = 1)
    gives the tensor-parallel layout described above, ``replicas`` the
    number of serving replicas folded into its rows."""
    forward = _make_decode_forward(cfg, scfg, ctx, replicas)
    cd = scfg.dtype

    def step(params, pool, tokens, pos, bt, lens, samp):
        x, pool = forward(params, pool, tokens, pos, bt, lens)
        logits = emb.lm_head_logits(_head(params, cfg), x.to(cd), ctx)
        nxt = sampling.sample_tokens(logits, samp, pos + 1,
                                     n_candidates=scfg.sample_candidates,
                                     ctx=ctx)
        return nxt.to(torch.int32), pool

    return step


def _make_window_forward(cfg, scfg: ServeConfig, ctx=None, replicas=1):
    """The chunk-window trunk: (params, pool, ids, start, n_tok, bt) ->
    (x, pool), ``x`` the final-norm hidden state at every window
    position ((TP, N, C, d_model) at tp > 1).

    ids (b, C) a right-padded token window per sequence; start (b,) the
    absolute position of ids[:, 0]; n_tok (b,) valid tokens in the
    window (0 = inactive slot).  Writes every valid position's K/V into
    the pages and attends each position against the pages written so
    far (position j sees ``start + j + 1`` tokens)."""
    _check_supported(cfg, ctx)
    P = scfg.page_tokens
    cd = scfg.dtype

    def window(params, pool, ids, start, n_tok, bt):
        x = emb.embed_lookup(params["embed"], ids, cd, ctx)
        t = ids.shape[1]
        ar = torch.arange(t, dtype=torch.int32, device=ids.device)
        pos = start[:, None] + ar[None]                       # (b, t)
        valid = ar[None] < n_tok[:, None]
        # token (b, j) -> page bt[b, pos//P] slot pos%P; the invalid
        # window tail lands in the null page
        sidx = (pos // P).clamp(0, bt.shape[1] - 1)
        page = bt.gather(1, sidx.long())
        page = torch.where(valid, page, torch.full_like(page, NULL_PAGE))
        slot = pos % P
        kv = _pages_view(pool, ctx)
        wpage = _pe_pages(page, pool, ctx)
        bt_k = _fold(_pe_pages(bt, pool, ctx), ctx)
        start_k, n_tok_k = _rep(start, ctx), _rep(n_tok, ctx)
        for li in range(cfg.n_layers):
            p = lm.layer(params["blocks"], li)
            h = rmsnorm(p["ln1"]["scale"], x).to(cd)
            q, k, v = attn.project_qkv(p["attn"], h, pos, cfg, ctx)
            _write_pages(kv, li, k, v, wpage, slot)
            # whole-window paged attention in one call: the window's K/V
            # were just written above
            o = ops.paged_prefill_attention(_fold(q, ctx), kv[:, 0, li],
                                            kv[:, 1, li], bt_k, start_k,
                                            n_tok_k, impl=scfg.attn_impl)
            x = x + _psum(attn.out_proj(_unfold(o, ctx).to(cd),
                                        p["attn"]["wo"], ctx), ctx)
            h = rmsnorm(p["ln2"]["scale"], x)
            x = x + (ff.moe_apply(p["mlp"], h, cfg, ctx, replicas) if cfg.moe
                     else ff.mlp_apply(p["mlp"], h, cfg, ctx))
        return rmsnorm(params["ln_f"]["scale"], x), pool

    return window


def make_prefill(cfg, scfg: ServeConfig, *, ctx=None, replicas=1):
    """Chunked prefill: (params, pool, ids, start, n_tok, bt, samp) ->
    (next_tokens, pool): the window trunk, then the token sampled after
    position ``start + n_tok - 1`` with RNG counter ``start + n_tok`` —
    meaningful only for slots whose chunk completes the prompt."""
    window = _make_window_forward(cfg, scfg, ctx, replicas)
    cd = scfg.dtype

    def prefill(params, pool, ids, start, n_tok, bt, samp):
        x, pool = window(params, pool, ids, start, n_tok, bt)
        b, t = ids.shape
        last = (n_tok - 1).clamp(0, t - 1).long()
        xl = x[..., torch.arange(b, device=x.device), last, :]
        logits = emb.lm_head_logits(_head(params, cfg), xl.to(cd), ctx)
        nxt = sampling.sample_tokens(logits, samp, start + n_tok,
                                     n_candidates=scfg.sample_candidates,
                                     ctx=ctx)
        return nxt.to(torch.int32), pool

    return prefill


def make_verify(cfg, scfg: ServeConfig, *, ctx=None, replicas=1):
    """Speculative verify: (params, pool, ids, start, n_tok, bt, samp) ->
    (target_tokens, pool), one forward over a (b, k+1) window through
    the chunked-prefill trunk, sampling at EVERY row.

    ids[:, 0] is the sequence's pending last token (its K/V unwritten,
    what a decode step would feed) and ids[:, 1:] the drafts; start (b,)
    the position of ids[:, 0]; n_tok (b,) = 1 + drafts.  Row j is the
    token the target generates at position ``start + j + 1``, drawn with
    the non-speculative key ``(rid, start + j + 1)``: row 0 IS the
    non-speculative next token, row j what the (j+1)-th sequential step
    would give if all j fed drafts matched."""
    window = _make_window_forward(cfg, scfg, ctx, replicas)
    cd = scfg.dtype

    def verify(params, pool, ids, start, n_tok, bt, samp):
        x, pool = window(params, pool, ids, start, n_tok, bt)
        t = ids.shape[1]
        logits = emb.lm_head_logits(_head(params, cfg), x.to(cd), ctx)
        ar = torch.arange(t, dtype=torch.int32, device=ids.device)
        pos = start[:, None] + ar[None] + 1                  # counters
        nxt = sampling.sample_window_tokens(
            logits, samp, pos, n_candidates=scfg.sample_candidates, ctx=ctx)
        return nxt.to(torch.int32), pool

    return verify


# ======================================================================
# execution substrate
# ======================================================================
class LocalExec:
    """Single-device execution: the step functions over the pool on one
    device (host arrays go to the device per call), and a loopback
    ``CommQueue`` (1 PE) for the migration drain: the reference's
    ``put_nbi`` + one ``quiet()`` path, landing pages in place."""

    n_pe = 1

    def __init__(self, params, cfg, scfg: ServeConfig, kv: PagedKVCache,
                 device: torch.device):
        self.params = params
        self.kv = kv
        self.device = device
        self._prefill = make_prefill(cfg, scfg)
        self._decode = make_decode_step(cfg, scfg)
        self._verify = make_verify(cfg, scfg)

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def init_pool(self) -> torch.Tensor:
        return self.kv.zeros(self.device)

    def prefill(self, pool, ids, start, n_tok, bt, samp):
        return self._prefill(self.params, pool, self._t(ids),
                             self._t(start), self._t(n_tok), self._t(bt),
                             samp)

    def decode(self, pool, tokens, pos, bt, lens, samp):
        return self._decode(self.params, pool, self._t(tokens),
                            self._t(pos), self._t(bt), self._t(lens), samp)

    def verify(self, pool, ids, start, n_tok, bt, samp):
        return self._verify(self.params, pool, self._t(ids),
                            self._t(start), self._t(n_tok), self._t(bt),
                            samp)

    def set_params(self, params) -> None:
        """Swap the served weights (the hot-swap flip): the step
        functions take ``params`` as an argument, so the next call runs
        the new generation."""
        self.params = params

    def migrate(self, pool, migrations):
        # whole-system view with one PE: a leading PE axis on a VIEW of
        # the pool, so the drained puts land in the pool itself.  A
        # cell's prefix pages are its own, so every move is a loopback:
        # its PE is row 0 of the view whatever the cell's PE id
        name = self.kv.handle.name
        state = {name: pool[None]}
        q = CommQueue(("data",), state, transport=InPlaceTransport(1))
        self.kv.issue_migrations(
            q, state[name],
            [dataclasses.replace(m, src_pe=0, dst_pe=0) for m in migrations])
        return pool

    # pool-layout hooks for the disaggregated handoff (serve.disagg): a
    # page "row" is the plain pool row, and it stays on the pool's device
    def read_pages(self, pool, pages) -> list:
        """Pool rows ``pages`` (the handoff payload) as views, one ``(1,
        *row)`` per page, no copy: a put snapshots its row at issue."""
        return [pool[p:p + 1] for p in pages]

    def write_pages(self, pool, pages, rows) -> torch.Tensor:
        """Land handed-off ``rows`` (one ``(1, *row)`` each) at pool rows
        ``pages``, in place, one device copy per row."""
        for p, r in zip(pages, rows):
            pool[p:p + 1].copy_(r)
        return pool


class StackedExec:
    """Tensor-parallel execution on the stacked team — the counterpart of
    the reference's ``MeshExec`` (``tests/multipe/run_serve.py``): ``R``
    serving replicas (the mesh's "data" axis), each a TP group of
    ``ctx.tp_size`` PEs ("model"), every PE on the leading axes of one
    pool tensor ``(R, TP, *page_geometry)``.

    Every step runs on every replica row, as ``shard_map`` does: the
    host arrays are tiled R times (replica-major rows), so each replica
    writes its own pool rows with the same batch and the pools equal the
    reference's; the host reads replica ``my_pe``'s tokens (the rows
    differ once pages migrate).  Weights are stacked once, ``(TP,
    ...)``, through ``weights.shard_for_tp`` (already-stacked parameters
    are kept as given, so cells can share one dict), never per replica.
    ``migrate`` moves a page between replicas as one ``put_nbi`` per TP
    rank over the flattened ``("data", "model")`` team and ONE
    ``quiet()``; ``read_pages`` / ``write_pages`` expose a page as its
    TP shards, ``(1, TP, *page_row)``, for the disaggregated handoff."""

    def __init__(self, params, cfg, ctx, scfg: ServeConfig,
                 kv: PagedKVCache, device: torch.device, *,
                 replicas: int = 1, my_pe: int = 0):
        if not 0 <= int(my_pe) < int(replicas):
            raise ValueError(f"my_pe {my_pe} outside {replicas} replicas")
        self.cfg, self.ctx, self.kv, self.device = cfg, ctx, kv, device
        self.replicas, self.my_pe = int(replicas), int(my_pe)
        self.tp = ctx.tp_size
        self.n_pe = self.replicas * self.tp
        self.set_params(params)
        rep = dict(ctx=ctx, replicas=self.replicas)
        self._prefill = make_prefill(cfg, scfg, **rep)
        self._decode = make_decode_step(cfg, scfg, **rep)
        self._verify = make_verify(cfg, scfg, **rep)
        self._team = Team(("data", "model"), (self.replicas, self.tp))

    def _tile(self, a):
        """A host array's rows for every replica, replica-major."""
        if self.replicas == 1 or np.ndim(a) == 0:
            return a
        return np.concatenate([a] * self.replicas)

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(self._tile(a))).to(
            self.device)

    def _samp(self, samp: dict) -> dict:
        return {k: self._tile(v) for k, v in samp.items()}

    def _mine(self, toks: torch.Tensor) -> torch.Tensor:
        return toks.unflatten(0, (self.replicas, -1))[self.my_pe]

    def init_pool(self) -> torch.Tensor:
        return pe_pool(self.kv.handle.shape, self.ctx, dtype=self.kv.dtype,
                       device=self.device, replicas=self.replicas)

    def _run(self, fn, pool, arrays, samp):
        toks, pool = fn(self.params, pool, *map(self._t, arrays),
                        self._samp(samp))
        return self._mine(toks), pool

    def prefill(self, pool, ids, start, n_tok, bt, samp):
        return self._run(self._prefill, pool, (ids, start, n_tok, bt), samp)

    def decode(self, pool, tokens, pos, bt, lens, samp):
        return self._run(self._decode, pool, (tokens, pos, bt, lens), samp)

    def verify(self, pool, ids, start, n_tok, bt, samp):
        return self._run(self._verify, pool, (ids, start, n_tok, bt), samp)

    def set_params(self, params) -> None:
        """Serve ``params`` (the hot-swap flip): full parameters are
        stacked for TP here, stacked ones kept as they are."""
        self.params = shard_for_tp(params, self.cfg, self.tp)

    def migrate(self, pool, migrations):
        """Each planned move (``src_pe`` / ``dst_pe`` are replicas) as one
        ``put_nbi`` per TP rank, ``(src * TP + t) -> (dst * TP + t)``,
        over the flattened team, drained by ONE ``quiet()``; the puts land
        in the pool in place (the queue's state is a view of it)."""
        name = self.kv.handle.name
        state = {name: pool.flatten(0, 1)}
        q = CommQueue(self._team, state, transport=InPlaceTransport(self.n_pe))
        tp = self.tp
        self.kv.issue_migrations(
            q, state[name], migrations,
            pairs_of=lambda m: [(m.src_pe * tp + t, m.dst_pe * tp + t)
                                for t in range(tp)])
        return pool

    def read_pages(self, pool, pages) -> list:
        """Replica ``my_pe``'s pool rows ``pages`` as their TP shards, one
        ``(1, TP, *page_row)`` view per page, no copy."""
        return [pool[self.my_pe, :, p:p + 1].transpose(0, 1) for p in pages]

    def write_pages(self, pool, pages, rows) -> torch.Tensor:
        """Land ``(1, TP, *page_row)`` rows at replica ``my_pe``'s pool
        rows ``pages``, in place."""
        for p, r in zip(pages, rows):
            pool[self.my_pe, :, p:p + 1].copy_(r.transpose(0, 1))
        return pool


# ======================================================================
# the host loop
# ======================================================================
class ServeEngine:
    """Continuous-batching host loop: token-budgeted ticks (one decode token
    or verify window per decoding sequence + chunked prefill), FCFS or
    SLO admission, preempt-by-eviction, migration drain first.
    ``device=None`` is the GPU (raises without one); tests pass
    ``device="cpu"``.  ``kv`` shares a cache with a draft model's
    proposer (``serve.spec.DraftModelProposer``); ``proposer`` overrides
    ``scfg.draft``.  ``role`` is ``"both"`` (colocated), or a
    disaggregated cell's ``"prefill"`` / ``"decode"``; ``my_pe`` is the
    cell's PE id.  ``ctx`` (default: tp = 1) with ``tp_size > 1`` serves
    tensor-parallel on the stacked team (``StackedExec``, one replica,
    unless ``exec_`` gives another substrate, e.g. a ``StackedExec``
    with replicas)."""

    def __init__(self, params, cfg, scfg: ServeConfig, *, ctx=None,
                 exec_=None, device=None,
                 kv: Optional[PagedKVCache] = None, proposer=None,
                 my_pe: int = 0, role: str = "both"):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown engine role {role!r}")
        ctx = ParallelCtx() if ctx is None else ctx
        _check_supported(cfg, ctx)
        self.cfg, self.ctx, self.scfg = cfg, ctx, scfg
        self.device = resolve(device)
        # disaggregated cells: a "prefill" engine stops at the first
        # token and parks the sequence on ``handoff_ready``; a "decode"
        # engine receives sequences through ``adopt_request`` (it still
        # re-prefills its own preemption victims: the counter-keyed
        # sampler gives the same tokens wherever a position is computed)
        self.role = role
        self.handoff_ready: list = []
        self.kv = kv = make_kv_cache(cfg, scfg, ctx) if kv is None else kv
        self.slo = SLOPolicy(scfg.slo) if scfg.slo is not None else None
        self.sched = FCFSScheduler(kv, max_batch=scfg.max_batch,
                                   max_seq=scfg.max_seq, my_pe=my_pe,
                                   prefill_chunk=scfg.prefill_chunk,
                                   tick_tokens=scfg.tick_tokens,
                                   spec_k=scfg.spec_k, slo=self.slo)
        if exec_ is not None:
            self.exec = exec_
        elif ctx.tp_size > 1:
            self.exec = StackedExec(params, cfg, ctx, scfg, kv, self.device)
        else:
            self.exec = LocalExec(params, cfg, scfg, kv, self.device)
        self.proposer = proposer
        if scfg.spec_k > 0 and proposer is None:
            from . import spec                 # engine <-> spec cycle
            self.proposer = spec.make_proposer(scfg.draft)
        self.spec_stats = {"drafted": 0, "accepted": 0, "emitted": 0,
                           "verify_ticks": 0, "verify_seqs": 0}
        self.pool = self.exec.init_pool()
        self.finished: list = []
        self.shed: list = []             # deadline-shed, never served
        # weight hot-swap (ckpt.hotswap): the in-flight streamer and its
        # lifetime accounting
        self._swap = None
        self.swap_stats = {"generation": 0, "flips": 0, "swap_ticks": 0,
                           "swap_batches": 0, "swap_bytes": 0,
                           "swap_extra_quiets": 0}
        self.ticks = 0
        # step-function calls: each runs every layer once, so the
        # kernel launch counts of a run are n_layers x these (verify
        # windows go through the prefill kernel)
        self.steps = {"prefill": 0, "decode": 0, "verify": 0}
        # inter-token gaps of decoding sequences (ITL/TPOT)
        self.itl: list = []
        self._last_tok: dict = {}        # rid -> time of last token

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.sampling.temperature > 0 \
                and req.sampling.top_k > self.scfg.sample_candidates:
            raise ValueError(
                f"request {req.rid}: top_k {req.sampling.top_k} exceeds "
                f"the sampler's candidate bound "
                f"{self.scfg.sample_candidates} "
                f"(raise ServeConfig.sample_candidates)")
        self.sched.submit(req)

    def begin_hot_swap(self, new_params, *, chunk_rows: int = 4,
                       row_bytes: int = 1 << 14) -> None:
        """Start streaming a new weight generation (``ckpt.hotswap``):
        each later tick advances the stream by one put-with-signal batch
        of ``chunk_rows`` rows of ``row_bytes`` bytes, and the generation
        flips at a tick boundary once everything has landed — serving
        never pauses and the swap queue pays no global drain.  The stream
        spans the exec's PEs (replicas x TP; one at tp = 1), as the
        reference's spans dp x tp; ``new_params`` are full parameters
        (a TP exec stacks them at the flip)."""
        if self._swap is not None:
            raise RuntimeError("a weight hot-swap is already in flight")
        self.swap_stats["generation"] += 1
        self._swap = WeightStreamer(
            new_params, n_pe=self.exec.n_pe,
            generation=self.swap_stats["generation"],
            chunk_rows=chunk_rows, row_bytes=row_bytes, device=self.device)

    def swap_in_flight(self) -> bool:
        return self._swap is not None

    def _swap_step(self) -> None:
        """The per-tick hot-swap hook: one streaming step; on the flip
        tick the reassembled generation replaces the served weights
        BEFORE this tick's forwards."""
        st = self._swap
        if not st.step():
            return
        self.exec.set_params(st.result())
        self._swap = None
        add_swap_stats(self.swap_stats, st)

    def tick(self, now: float = 0.0) -> None:
        """One engine tick: hot-swap stream step (when one is in flight)
        -> schedule -> migrate (one quiet) -> chunked prefill for every
        prefilling sequence's quota -> one decode token (or verify
        window) for every decoding sequence -> retire finished."""
        self.ticks += 1
        if self._swap is not None:
            self._swap_step()
        plan = self.sched.tick(now)
        for r in plan.shed:              # deadline drops: never served
            self.shed.append(r)
            self._last_tok.pop(r.rid, None)
            if self.proposer is not None:
                self.proposer.drop(r.rid)
        for r in plan.preempted:         # progress resets, gaps with it
            self._last_tok.pop(r.rid, None)
            if self.proposer is not None:
                self.proposer.drop(r.rid)
        if plan.migrations:
            self.pool = self.exec.migrate(self.pool, tuple(plan.migrations))
        skip_rids = set()
        if plan.prefill:
            skip_rids = self._chunk_prefill(plan.prefill, now)
        self._decode_tick(skip_rids=skip_rids, now=now)

    def _samp_state(self, reqs) -> dict:
        return sampling.batch_state(reqs, self.scfg.max_batch,
                                    self.scfg.sample_seed)

    def _chunk_prefill(self, assignments, now):
        """Feed every (req, n) chunk assignment through the prefill
        step.  Returns the rids that COMPLETED prefill this tick (their
        first token came from the chunk; they do not also decode)."""
        B, C = self.scfg.max_batch, self.scfg.prefill_chunk
        reqs = [r for r, _ in assignments]
        ids = np.zeros((B, C), np.int32)
        start = np.zeros((B,), np.int32)
        n_tok = np.zeros((B,), np.int32)
        for i, (r, n) in enumerate(assignments):
            ids[i, :n] = r.prompt[r.n_done:r.n_done + n]
            start[i] = r.n_done
            n_tok[i] = n
        bt = self.kv.block_table(
            [r.rid for r in reqs] + [None] * (B - len(reqs)),
            self.scfg.table_slots)
        toks, self.pool = self.exec.prefill(self.pool, ids, start, n_tok,
                                            bt, self._samp_state(reqs))
        self.steps["prefill"] += 1
        toks = toks.cpu().numpy()
        done = set()
        for i, (r, n) in enumerate(assignments):
            self.sched.note_chunk(r, n, int(toks[i]), now)
            if not r.is_prefilling():
                done.add(r.rid)
                if self.role == "prefill" and not r.finished():
                    # a prefill cell's part ends with the first token:
                    # park the sequence for the page handoff (its pages
                    # stay resident as the payload source until the
                    # decode cell acknowledges)
                    self.sched.release(r)
                    self.handoff_ready.append(r)
                    continue
                self._last_tok[r.rid] = now
                self._maybe_finish(r, now)
        return done

    def adopt_request(self, req: Request, pages, now: float = 0.0) -> None:
        """Decode-cell half of a handoff: attach the landing pages
        (already filled by the producer's put-with-signal stream, drained
        by ``signal_wait_until``) and enter the sequence into this cell's
        scheduler mid-life."""
        if self.role == "prefill":
            raise RuntimeError("a prefill cell cannot adopt sequences")
        self.kv.attach_seq(req.rid, pages)
        self.sched.adopt(req)
        # its first token was emitted on the producer cell; the next
        # inter-token gap is measured from adoption
        self._last_tok[req.rid] = now

    def _decode_tick(self, skip_rids, now):
        if self.role == "prefill":
            return
        batch = [r for r in self.sched.running
                 if not r.is_prefilling() and r.rid not in skip_rids]
        if not batch:
            return
        if self.scfg.spec_k > 0:
            return self._spec_tick(batch, now)
        B = self.scfg.max_batch
        tokens = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, r in enumerate(batch):
            tokens[i] = r.next_input()
            p = r.n_prompt + len(r.out) - 1
            pos[i] = p
            lens[i] = p + 1
        bt = self.kv.block_table(
            [r.rid for r in batch] + [None] * (B - len(batch)),
            self.scfg.table_slots)
        toks, self.pool = self.exec.decode(self.pool, tokens, pos, bt,
                                           lens, self._samp_state(batch))
        self.steps["decode"] += 1
        toks = toks.cpu().numpy()
        for i, r in enumerate(batch):
            self.sched.advance(r, int(toks[i]), now)
            prev = self._last_tok.get(r.rid)
            if prev is not None:
                self.itl.append(now - prev)
            self._last_tok[r.rid] = now
            self._maybe_finish(r, now)

    def _spec_tick(self, batch, now):
        """Draft -> verify -> accept -> rewind, one verify forward for
        every decoding sequence.

        The proposer supplies up to ``draft_allowance(r)`` drafts per
        sequence (the scheduler already budgeted and paged them); ONE
        verify pass scores the pending token plus all drafts; exact
        prefix matching against the target's own counter-RNG draws
        accepts ``m`` drafts and emits ``m + 1`` tokens (point proposals
        against a deterministic draw: the accept test is exact
        matching).  Rejected positions rewind: page-granular
        ``kv.truncate`` plus the length bookkeeping the scheduler
        keeps."""
        B, K = self.scfg.max_batch, self.scfg.spec_k
        allow = [self.sched.draft_allowance(r) for r in batch]
        drafts = self.proposer.propose(batch, allow)
        ids = np.zeros((B, K + 1), np.int32)
        start = np.zeros((B,), np.int32)
        n_tok = np.zeros((B,), np.int32)
        for i, r in enumerate(batch):
            d = drafts[i][:allow[i]]
            drafts[i] = d
            ids[i, 0] = r.next_input()
            if d:
                ids[i, 1:1 + len(d)] = d
            start[i] = r.n_prompt + len(r.out) - 1
            n_tok[i] = 1 + len(d)
        bt = self.kv.block_table(
            [r.rid for r in batch] + [None] * (B - len(batch)),
            self.scfg.table_slots)
        toks, self.pool = self.exec.verify(self.pool, ids, start, n_tok,
                                           bt, self._samp_state(batch))
        self.steps["verify"] += 1
        toks = toks.cpu().numpy()
        self.spec_stats["verify_ticks"] += 1
        self.spec_stats["verify_seqs"] += len(batch)
        for i, r in enumerate(batch):
            d = drafts[i]
            m = 0
            while m < len(d) and int(toks[i, m]) == int(d[m]):
                m += 1
            # the allowance caps drafts at the output budget, so emitting
            # every accepted token never overshoots
            emit = min(m + 1, r.max_new - len(r.out))
            self.spec_stats["drafted"] += len(d)
            self.spec_stats["accepted"] += m
            self.spec_stats["emitted"] += emit
            prev = self._last_tok.get(r.rid)
            for j in range(emit):
                self.sched.advance(r, int(toks[i, j]), now)
                if prev is not None:
                    # one pass's tokens arrive together: the first closes
                    # the inter-token gap, the rest are free
                    self.itl.append(now - prev if j == 0 else 0.0)
            self._last_tok[r.rid] = now
            if r.finished():
                self._maybe_finish(r, now)
                continue
            if not d:
                continue      # nothing speculative was written
            # rewind: K/V is valid through the last ACCEPTED position (the
            # newest token's K/V is written when it is fed next tick)
            self.kv.truncate(r.rid, r.n_prompt + len(r.out) - 1)
            self.proposer.rewind(r.rid, r.n_prompt + len(r.out) - 1)

    def _maybe_finish(self, r, now):
        if not r.is_prefilling() and r.finished():
            self.sched.finish(r, now,
                              register_prefix=self.scfg.prefix_keep)
            self.finished.append(r)
            # a reused rid must not see this request's last-token time
            self._last_tok.pop(r.rid, None)
            if self.proposer is not None:
                self.proposer.drop(r.rid)

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], *, clock: str = "wall",
            max_ticks: int = 100_000) -> list:
        """Replay an arrival trace to completion.  ``clock="wall"``
        admits by elapsed wall time (benchmarking); ``"tick"`` admits by
        tick count (deterministic, what the parity tests use)."""
        pending = sorted(requests, key=lambda r: r.t_arrive)
        t0 = time.monotonic()
        skipped = 0.0          # idle time fast-forwarded past
        for _ in range(max_ticks):
            now = (self.ticks if clock == "tick"
                   else time.monotonic() - t0 + skipped)
            while pending and pending[0].t_arrive <= now:
                self.submit(pending.pop(0))
            if not self.sched.has_work():
                if not pending:
                    if self._swap is None:
                        return self.finished
                    self.tick(now)       # drain the in-flight hot swap
                    continue
                if clock == "wall":      # fast-forward idle gaps
                    skipped += pending[0].t_arrive - now
                    now = time.monotonic() - t0 + skipped
                self.submit(pending.pop(0))
            self.tick(now)
        raise RuntimeError(f"serve loop did not converge in {max_ticks} "
                           f"ticks ({len(self.finished)} finished)")

    def reset_metrics(self) -> None:
        """Forget finished requests and counters (page/pool state
        stays), so a measured run follows a warm-up run on one engine."""
        self.finished.clear()
        self.shed.clear()
        self.ticks = 0
        self.steps = {"prefill": 0, "decode": 0, "verify": 0}
        self.itl.clear()
        self._last_tok.clear()
        for stats in (self.sched.stats, self.kv.stats, self.spec_stats):
            for k in stats:
                stats[k] = 0
        reset_swap_stats(self.swap_stats)
        if self.slo is not None:
            self.slo.reset()

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        """Throughput/latency summary over finished requests."""
        lat = np.array([r.t_finish - r.t_arrive for r in self.finished])
        ttft = np.array([r.t_first - r.t_arrive for r in self.finished
                         if r.t_first is not None])
        dec = np.asarray(self.itl)
        toks = sum(len(r.out) for r in self.finished)
        span = max((r.t_finish for r in self.finished), default=0.0) \
            - min((r.t_arrive for r in self.finished), default=0.0)
        pct = (lambda a, p: float(np.percentile(a, p)) if a.size else 0.0)
        sp = dict(self.spec_stats)
        sp["accept_rate"] = (sp["accepted"] / sp["drafted"]
                             if sp["drafted"] else 0.0)
        # tokens one sequence's verify pass emits (> 1: speculation beats
        # one token per tick)
        sp["tokens_per_tick"] = (sp["emitted"] / sp["verify_seqs"]
                                 if sp["verify_seqs"] else 0.0)
        return {
            "requests": len(self.finished),
            "tokens_out": int(toks),
            "span_s": float(span),
            "throughput_tok_s": toks / span if span > 0 else 0.0,
            "latency_p50_s": pct(lat, 50), "latency_p99_s": pct(lat, 99),
            "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
            "decode_p50_s": pct(dec, 50), "decode_p99_s": pct(dec, 99),
            "ticks": self.ticks,
            "steps": dict(self.steps),
            "sched": dict(self.sched.stats),
            "kv": dict(self.kv.stats),
            "spec": sp,
            "slo": slo_summary(self.finished, self.shed,
                               self.slo.stats if self.slo is not None
                               else None),
            "swap": dict(self.swap_stats),
        }


def add_swap_stats(stats: dict, st) -> None:
    """Fold a flipped streamer's accounting into ``stats``."""
    stats["flips"] += st.stats["flips"]
    stats["swap_ticks"] += st.stats["swap_ticks"]
    stats["swap_batches"] += st.stats["batches"]
    stats["swap_bytes"] += st.stats["bytes"]
    stats["swap_extra_quiets"] += st.extra_global_drains()


def reset_swap_stats(stats: dict) -> None:
    for k in stats:
        if k != "generation":            # generations keep counting up
            stats[k] = 0


def slo_summary(finished, shed, policy_stats=None) -> dict:
    """Per-class SLO attainment and shed counts over a served trace.
    Attainment is TTFT against each request's own ``deadline`` (none
    counts as attained); shed requests count in their class's shed
    bucket, never against attainment."""
    out: dict = {"attained": {}, "finished": {}, "shed": {}}
    for p in PRIORITIES:
        done = [r for r in finished if r.priority == p]
        ok = [r for r in done
              if r.deadline is None
              or (r.t_first is not None
                  and r.t_first - r.t_arrive <= r.deadline)]
        out["finished"][p] = len(done)
        out["attained"][p] = (len(ok) / len(done)) if done else 1.0
        out["shed"][p] = sum(1 for r in shed if r.priority == p)
    if policy_stats is not None:
        out["policy"] = dict(policy_stats)
    return out
