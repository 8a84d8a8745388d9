"""Speculative decoding — pluggable draft proposers for the paged
serving engine (the counterpart of ``repro.serve.spec``).

Draft-then-verify turns N sequential decode ticks into one batched
verify pass: a cheap PROPOSER guesses ``k`` tokens per running
sequence, the target model scores the pending token plus all drafts in
ONE ``(B, k+1)`` forward through the chunked-prefill machinery
(``engine.make_verify`` over ``ops.paged_prefill_attention``), and the
engine accepts the longest prefix of drafts that matches what the
target itself generates.

**Losslessness.**  The target's draw at a position is a pure function
of its counter-RNG key ``(rid, position)`` (``serve.sampling``), i.e. a
DETERMINISTIC point distribution once the key is fixed.  Leviathan-
style rejection sampling (accept draft ``d`` with probability
``min(1, p_target(d) / p_draft(d))``, resample the residual otherwise)
therefore collapses: the proposers here make point proposals (one-hot
draft distributions) and the target's counter draw is one-hot too, so
the accept test degenerates to EXACT MATCHING and the residual
resample IS the target's own draw — which is what makes accepted
streams equal to non-speculative decoding, greedy and sampled alike,
wherever the verify window's rows score as a decode step would.
Proposers can therefore never change WHAT is generated, only how many
ticks it takes: a bad proposer costs verify compute, a good one emits
``m + 1`` tokens per tick.

Proposers are host-side objects with three hooks:

    propose(reqs, allow) -> list[list[int]]   up to allow[i] drafts per
                                              decoding sequence
    rewind(rid, n_valid)                      verify rejected a suffix;
                                              tokens past ``n_valid``
                                              never happened
    drop(rid)                                 sequence finished or was
                                              preempted (all state gone)

Included proposers:

  * :class:`NgramProposer` — prompt-lookup self-drafting (no second
    model): propose the continuation of the most recent earlier
    occurrence of the context's longest matching suffix n-gram.  Free,
    and strong exactly where speculation pays: repeated prompts,
    greedy repetition loops, copy-heavy decoding.
  * :class:`DraftModelProposer` — a SMALL draft model on the engine's
    device and the target's page geometry: the draft keeps its own page
    pool shaped by its own layer/head counts but indexed by the SAME
    block tables, so one allocator (and one ``truncate`` rewind)
    governs both caches.
  * :class:`ReplayProposer` — oracle drafts from known streams (tests
    and benchmark upper bounds: accept-rate 1, ``k+1`` tokens/tick).
  * :class:`FixedProposer` — a constant (usually wrong) proposal, the
    adversarial case pinning the rewind path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.parallel import tp_of
from repro_torch.weights import shard_for_tp

from . import sampling
from .engine import ServeConfig, make_decode_step, make_prefill, pe_pool
from .kv_cache import PagedKVCache


class SpecProposer:
    """Protocol base: a proposer that never proposes (spec decode with
    this degenerates to plain decode through the verify window)."""

    def propose(self, reqs, allow) -> list:
        return [[] for _ in reqs]

    def rewind(self, rid, n_valid: int) -> None:
        pass

    def drop(self, rid) -> None:
        pass


class NgramProposer(SpecProposer):
    """Prompt-lookup self-drafting (n-gram speculation).

    For each sequence, take the longest suffix n-gram of its full
    history (prompt + generated tokens), find its most recent EARLIER
    occurrence, and propose the tokens that followed it.  Matches are
    tried from ``max_n`` down to ``min_n``; no match -> no drafts (the
    verify window then carries just the pending token, i.e. a plain
    decode step).  Host-side and deterministic, so it cannot perturb
    the scheduler's backend-invariant decisions."""

    def __init__(self, min_n: int = 1, max_n: int = 3):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.min_n, self.max_n = int(min_n), int(max_n)

    def propose(self, reqs, allow):
        return [self._one(r, a) for r, a in zip(reqs, allow)]

    def _one(self, req, k: int) -> list:
        if k <= 0:
            return []
        hist = list(req.prompt) + list(req.out)
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(hist) <= n:
                continue
            suffix = hist[-n:]
            # most recent occurrence strictly before the suffix itself
            for j in range(len(hist) - n - 1, -1, -1):
                if hist[j:j + n] == suffix:
                    return [int(t) for t in hist[j + n:j + n + k]]
        return []


class ReplayProposer(SpecProposer):
    """Oracle drafts replayed from known output streams (``rid ->
    token list``).  Every draft is accepted by construction, so it
    measures the verify path's ``k+1`` tokens-per-tick ceiling — the
    tests' deterministic multi-accept case."""

    def __init__(self, streams: dict):
        self.streams = {int(rid): [int(t) for t in toks]
                        for rid, toks in streams.items()}

    def propose(self, reqs, allow):
        out = []
        for r, a in zip(reqs, allow):
            stream = self.streams.get(r.rid, [])
            out.append(stream[len(r.out):len(r.out) + max(a, 0)])
        return out


class FixedProposer(SpecProposer):
    """Always proposes the same tokens — the adversarial case: every
    draft the target disagrees with is rejected and rewound."""

    def __init__(self, tokens):
        self.tokens = [int(t) for t in tokens]

    def propose(self, reqs, allow):
        return [self.tokens[:max(a, 0)] for _, a in zip(reqs, allow)]


class DraftModelProposer(SpecProposer):
    """A small draft model drafting greedily on the target's page
    geometry, on the engine's device.

    The draft keeps its OWN page pool — shaped by the draft config's
    ``(n_layers, kv_heads, head_dim)`` but with the target pool's
    ``(n_pages, page_tokens)`` — indexed by the SAME block tables the
    target uses, so page allocation, eviction and speculative rewind
    are decided once (by the shared :class:`PagedKVCache`) for both
    caches.  Per tick the proposer (a) CATCHES UP: chunk-prefills any
    history tokens the draft has not processed (accepted tokens it
    drafted itself re-feed idempotently — same pages, same slots), the
    final window's sample being the first draft; then (b) DRAFTS:
    ``allow - 1`` greedy single-token decode steps.  Both step
    functions are the engine's own (``make_prefill`` /
    ``make_decode_step``) built from the draft config, so the draft runs
    the same paged-attention kernels as the target.  ``params`` may be
    the target's own dict: only the pool is new.

    The draft's token ids must mean the same thing as the target's:
    construction requires matching vocabularies."""

    def __init__(self, params, cfg, scfg: ServeConfig, kv: PagedKVCache,
                 *, target_vocab: int | None = None, device=None, ctx=None):
        if target_vocab is not None and cfg.vocab != target_vocab:
            raise ValueError(
                f"draft model vocab {cfg.vocab} != target vocab "
                f"{target_vocab}: draft tokens would be meaningless")
        self.cfg, self.scfg, self.kv = cfg, scfg, kv
        self.device = resolve(device)
        tp = tp_of(ctx)
        # under a TP target the draft runs on the target's ctx: its
        # weights stacked once, its pool one replica of TP PEs
        self.params = shard_for_tp(params, cfg, tp)
        self._prefill = make_prefill(cfg, scfg, ctx=ctx)
        self._decode = make_decode_step(cfg, scfg, ctx=ctx)
        self.pool = pe_pool(
            (kv.n_pages, 2, cfg.n_layers, kv.page_tokens,
             cfg.kv_per_rank(tp), cfg.head_dim), ctx, dtype=scfg.dtype,
            device=self.device)
        # drafts are the draft model's GREEDY continuations: argmax
        # needs no RNG, so drafting is deterministic by construction
        self._greedy = sampling.batch_state([], scfg.max_batch, 0)
        self.seen: dict = {}           # rid -> history tokens processed
        # step-function calls (each runs every draft layer once)
        self.steps = {"prefill": 0, "decode": 0}

    def rewind(self, rid, n_valid: int) -> None:
        if rid in self.seen:
            self.seen[rid] = min(self.seen[rid], int(n_valid))

    def drop(self, rid) -> None:
        self.seen.pop(rid, None)

    # ------------------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tables(self, reqs, live) -> torch.Tensor:
        """Block tables with non-participating rows nulled, so their
        placeholder writes land in the null page instead of scribbling
        over a live sequence's draft K/V."""
        B = self.scfg.max_batch
        ids = [r.rid if i in live else None for i, r in enumerate(reqs)]
        return self._t(self.kv.block_table(ids + [None] * (B - len(reqs)),
                                           self.scfg.table_slots))

    def propose(self, reqs, allow):
        B, C = self.scfg.max_batch, self.scfg.prefill_chunk
        hist = {r.rid: list(r.prompt) + list(r.out) for r in reqs}
        first: dict = {}
        # --- catch-up: feed unseen history in prefill-chunk windows
        while True:
            pend = [i for i, r in enumerate(reqs) if allow[i] > 0
                    and self.seen.get(r.rid, 0) < len(hist[r.rid])]
            if not pend:
                break
            ids = np.zeros((B, C), np.int32)
            start = np.zeros((B,), np.int32)
            n_tok = np.zeros((B,), np.int32)
            for i in pend:
                h, s = hist[reqs[i].rid], self.seen.get(reqs[i].rid, 0)
                n = min(C, len(h) - s)
                ids[i, :n] = h[s:s + n]
                start[i], n_tok[i] = s, n
            toks, self.pool = self._prefill(
                self.params, self.pool, self._t(ids), self._t(start),
                self._t(n_tok), self._tables(reqs, set(pend)), self._greedy)
            self.steps["prefill"] += 1
            toks = toks.cpu().numpy()
            for i in pend:
                rid = reqs[i].rid
                self.seen[rid] = int(start[i] + n_tok[i])
                if self.seen[rid] == len(hist[rid]):
                    first[rid] = int(toks[i])    # the first draft token
        # --- draft: allow-1 further greedy decode steps
        drafts = [[first[r.rid]] if allow[i] > 0 and r.rid in first
                  else [] for i, r in enumerate(reqs)]
        for t in range(1, max(allow, default=0)):
            live = {i for i, r in enumerate(reqs)
                    if allow[i] > t and drafts[i]}
            if not live:
                break
            tokens = np.zeros((B,), np.int32)
            pos = np.zeros((B,), np.int32)
            lens = np.zeros((B,), np.int32)
            for i in live:
                tokens[i] = drafts[i][-1]
                p = len(hist[reqs[i].rid]) + t - 1
                pos[i], lens[i] = p, p + 1
            toks, self.pool = self._decode(
                self.params, self.pool, self._t(tokens), self._t(pos),
                self._tables(reqs, live), self._t(lens), self._greedy)
            self.steps["decode"] += 1
            toks = toks.cpu().numpy()
            for i in live:
                drafts[i].append(int(toks[i]))
        return drafts


PROPOSERS = ("ngram",)


def make_proposer(name: str) -> SpecProposer:
    """Build a parameterless proposer by name (``ServeConfig.draft``).
    Model-backed proposers need params and a config and are built by the
    caller (see ``launch/serve.py``)."""
    if name == "ngram":
        return NgramProposer()
    raise ValueError(
        f"unknown draft proposer '{name}' (parameterless: {PROPOSERS}; "
        f"model-backed drafting: construct serve.spec.DraftModelProposer "
        f"and pass it as ServeEngine(..., proposer=...))")
