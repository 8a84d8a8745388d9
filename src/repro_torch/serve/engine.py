"""Continuous-batching inference engine over the paged symmetric-heap
KV cache — the counterpart of ``repro.serve.engine`` for colocated,
single-device serving of a dense or MoE decoder.

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
    tokens, the streams do depend on what shares a step.
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
    prompts' full pages stay as a migratable prefix cache.

The pool is updated IN PLACE: page writes are ``index_put_`` on the
per-layer view of the pool tensor, where the reference does a
functional ``.at[].set`` and threads the new pool through ``scan``.
The step functions still return the pool, so the host loop reads like the
reference's.

Batch slots are fixed (``ServeConfig.max_batch``): empty slots carry
the null page table and length 0, which zeroes their attention output
and routes their K/V writes to the null page.

Not ported yet (raises ``NotImplementedError``): the sliding window
over the paged cache.  Disaggregated cells, the AMO
router and weight hot-swap live in ``launch/serve.py``'s refusals.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.heap import SymmetricHeap
from repro_torch.core.ordering import CommQueue, LocalTransport
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import embed as emb
from repro_torch.models import lm
from repro_torch.models import mlp as ff
from repro_torch.models.common import rmsnorm

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


def _check_supported(cfg) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"repro_torch.serve drives dense/moe decoders; got {cfg.family}")
    if cfg.swa_window is not None:
        raise NotImplementedError("sliding-window + paged cache: not yet")


# ======================================================================
# step functions
# ======================================================================
def _write_pages(pool, li, k, v, page, slot):
    """Write K/V rows into layer ``li`` of the pool, in place:
    ``pool[page, 0|1, li, slot] = k|v``.  ``page``/``slot`` index tensors
    of any shape S, k/v of shape S + (kvh, dh).  Inactive slots carry
    the null page, so their rows land in page 0."""
    idx = (page.long(), slot.long())
    pool[:, 0, li].index_put_(idx, k.to(pool.dtype))
    pool[:, 1, li].index_put_(idx, v.to(pool.dtype))


def _make_decode_forward(cfg, scfg: ServeConfig):
    """The decode trunk: (params, pool, tokens, pos, bt, lens) -> (x,
    pool), ``x`` (b, d_model) the final-norm hidden state of each slot's
    token.

    tokens (b,) input token per slot; pos (b,) its position; bt
    (b, table_slots) int32 block tables; lens (b,) int32 valid tokens
    AFTER this write (pos+1 for live slots, 0 for empty ones)."""
    _check_supported(cfg)
    P = scfg.page_tokens
    cd = scfg.dtype

    def forward(params, pool, tokens, pos, bt, lens):
        x = emb.embed_lookup(params["embed"], tokens[:, None], cd)[:, 0]
        b = x.shape[0]
        page = bt.gather(1, (pos // P)[:, None].long())[:, 0]
        slot = pos % P
        for li in range(cfg.n_layers):
            p = lm.layer(params["blocks"], li)
            h = rmsnorm(p["ln1"]["scale"], x).to(cd)
            q, k, v = attn.project_qkv(p["attn"], h[:, None], pos[:, None],
                                       cfg)
            _write_pages(pool, li, k[:, 0], v[:, 0], page, slot)
            o = ops.paged_attention(q[:, 0], pool[:, 0, li], pool[:, 1, li],
                                    bt, lens, impl=scfg.attn_impl)
            x = x + o.reshape(b, -1).to(cd) @ p["attn"]["wo"].to(cd)
            x = x + lm._decode_mlp(p["mlp"], rmsnorm(p["ln2"]["scale"], x),
                                   cfg)
        return rmsnorm(params["ln_f"]["scale"], x), pool

    return forward


def make_decode_step(cfg, scfg: ServeConfig):
    """One decode tick: (params, pool, tokens, pos, bt, lens, samp) ->
    (next_tokens, pool): the decode trunk, then the sampler (``samp``
    the ``sampling.batch_state`` arrays)."""
    forward = _make_decode_forward(cfg, scfg)
    cd = scfg.dtype

    def step(params, pool, tokens, pos, bt, lens, samp):
        x, pool = forward(params, pool, tokens, pos, bt, lens)
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        logits = emb.lm_head_logits(head, x.to(cd))
        nxt = sampling.sample_tokens(logits, samp, pos + 1,
                                     n_candidates=scfg.sample_candidates)
        return nxt.to(torch.int32), pool

    return step


def _make_window_forward(cfg, scfg: ServeConfig):
    """The chunk-window trunk: (params, pool, ids, start, n_tok, bt) ->
    (x, pool), ``x`` the final-norm hidden state at every window
    position.

    ids (b, C) a right-padded token window per sequence; start (b,) the
    absolute position of ids[:, 0]; n_tok (b,) valid tokens in the
    window (0 = inactive slot).  Writes every valid position's K/V into
    the pages and attends each position against the pages written so
    far (position j sees ``start + j + 1`` tokens)."""
    _check_supported(cfg)
    P = scfg.page_tokens
    cd = scfg.dtype

    def window(params, pool, ids, start, n_tok, bt):
        x = emb.embed_lookup(params["embed"], ids, cd)
        b, t = ids.shape
        ar = torch.arange(t, dtype=torch.int32, device=ids.device)
        pos = start[:, None] + ar[None]                       # (b, t)
        valid = ar[None] < n_tok[:, None]
        # token (b, j) -> page bt[b, pos//P] slot pos%P; the invalid
        # window tail lands in the null page
        sidx = (pos // P).clamp(0, bt.shape[1] - 1)
        page = bt.gather(1, sidx.long())
        page = torch.where(valid, page, torch.full_like(page, NULL_PAGE))
        slot = pos % P
        for li in range(cfg.n_layers):
            p = lm.layer(params["blocks"], li)
            h = rmsnorm(p["ln1"]["scale"], x).to(cd)
            q, k, v = attn.project_qkv(p["attn"], h, pos, cfg)
            _write_pages(pool, li, k, v, page, slot)
            # whole-window paged attention in one call: the window's K/V
            # were just written above
            o = ops.paged_prefill_attention(q, pool[:, 0, li],
                                            pool[:, 1, li], bt, start, n_tok,
                                            impl=scfg.attn_impl)
            x = x + o.reshape(b, t, -1).to(cd) @ p["attn"]["wo"].to(cd)
            x = x + (ff.moe_apply if cfg.moe else ff.mlp_apply)(
                p["mlp"], rmsnorm(p["ln2"]["scale"], x), cfg)
        return rmsnorm(params["ln_f"]["scale"], x), pool

    return window


def make_prefill(cfg, scfg: ServeConfig):
    """Chunked prefill: (params, pool, ids, start, n_tok, bt, samp) ->
    (next_tokens, pool): the window trunk, then the token sampled after
    position ``start + n_tok - 1`` with RNG counter ``start + n_tok`` —
    meaningful only for slots whose chunk completes the prompt."""
    window = _make_window_forward(cfg, scfg)
    cd = scfg.dtype

    def prefill(params, pool, ids, start, n_tok, bt, samp):
        x, pool = window(params, pool, ids, start, n_tok, bt)
        b, t = ids.shape
        last = (n_tok - 1).clamp(0, t - 1).long()
        xl = x[torch.arange(b, device=x.device), last]
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        logits = emb.lm_head_logits(head, xl.to(cd))
        nxt = sampling.sample_tokens(logits, samp, start + n_tok,
                                     n_candidates=scfg.sample_candidates)
        return nxt.to(torch.int32), pool

    return prefill


def make_verify(cfg, scfg: ServeConfig):
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
    window = _make_window_forward(cfg, scfg)
    cd = scfg.dtype

    def verify(params, pool, ids, start, n_tok, bt, samp):
        x, pool = window(params, pool, ids, start, n_tok, bt)
        t = ids.shape[1]
        head = params["embed"] if cfg.tie_embeddings else params["head"]
        logits = emb.lm_head_logits(head, x.to(cd))          # (b, t, V)
        ar = torch.arange(t, dtype=torch.int32, device=ids.device)
        pos = start[:, None] + ar[None] + 1                  # counters
        nxt = sampling.sample_window_tokens(
            logits, samp, pos, n_candidates=scfg.sample_candidates)
        return nxt.to(torch.int32), pool

    return verify


# ======================================================================
# execution substrate
# ======================================================================
class _PoolTransport(LocalTransport):
    """``LocalTransport`` that lands each put in the state tensor itself
    (a view of the engine's pool), on its device: no copy of the pool
    per put, only of the page payloads ``put_nbi`` snapshots."""

    def put(self, state, handle, data, pairs, team, offset):
        buf = state[handle.name]
        data = torch.as_tensor(data, device=buf.device)
        rows = data.shape[1] if data.dim() > 1 else 1
        for s, d in pairs:
            buf[d, offset:offset + rows] = data[s]
        return state


class LocalExec:
    """Single-device execution: the step functions over the pool on one
    device (host arrays go to the device per call), and a loopback
    ``CommQueue`` (1 PE) for the migration drain: the reference's
    ``put_nbi`` + one ``quiet()`` path, landing pages in place."""

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

    def migrate(self, pool, migrations):
        # whole-system view with one PE: a leading PE axis on a VIEW of
        # the pool, so the drained puts land in the pool itself
        name = self.kv.handle.name
        state = {name: pool[None]}
        q = CommQueue(("data",), state, transport=_PoolTransport(1))
        self.kv.issue_migrations(q, state[name], migrations)
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
    ``scfg.draft``."""

    def __init__(self, params, cfg, scfg: ServeConfig, *, device=None,
                 kv: Optional[PagedKVCache] = None, proposer=None):
        _check_supported(cfg)
        self.cfg, self.scfg = cfg, scfg
        self.device = resolve(device)
        if kv is None:
            kv = PagedKVCache(
                SymmetricHeap(("data",)), n_layers=cfg.n_layers,
                kv_heads=cfg.kv_per_rank(1), head_dim=cfg.head_dim,
                n_pages=scfg.n_pages, page_tokens=scfg.page_tokens,
                dtype=scfg.dtype)
        self.kv = kv
        self.slo = SLOPolicy(scfg.slo) if scfg.slo is not None else None
        self.sched = FCFSScheduler(kv, max_batch=scfg.max_batch,
                                   max_seq=scfg.max_seq,
                                   prefill_chunk=scfg.prefill_chunk,
                                   tick_tokens=scfg.tick_tokens,
                                   spec_k=scfg.spec_k, slo=self.slo)
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

    def tick(self, now: float = 0.0) -> None:
        """One engine tick: schedule -> migrate (one quiet) -> chunked
        prefill for every prefilling sequence's quota -> one decode token
        (or verify window) for every decoding sequence -> retire
        finished."""
        self.ticks += 1
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
                self._last_tok[r.rid] = now
                self._maybe_finish(r, now)
        return done

    def _decode_tick(self, skip_rids, now):
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
                    return self.finished
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
        }


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
