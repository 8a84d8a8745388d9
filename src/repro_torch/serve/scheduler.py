"""FCFS continuous batching with preempt-by-eviction and token-budgeted
chunked prefill — the counterpart of ``repro.serve.scheduler`` for a
colocated engine (the disaggregated handoff, ``release``/``adopt``, is
not here).

  * requests queue FCFS; a request is ADMITTED when a batch slot is
    free and the pool can cover its prompt + one decode page;
  * every engine tick decodes ONE token for every decoding sequence
    (with speculation, its whole verify window: the pending token plus
    ``draft_allowance`` drafts), and hands every PREFILLING sequence
    (fresh admission, preemption re-prefill, or a prefix-cache resume's
    uncovered suffix) up to ``prefill_chunk`` prompt tokens, under one
    shared per-tick token budget (``tick_tokens``) — decode claims its
    tokens first;
  * when a sequence needs a page and the pool is dry, the YOUNGEST
    running sequence is preempted by eviction: its pages are freed and
    it re-queues at the head of the line to re-prefill later;
  * a request whose prompt prefix is in the KV cache's prefix index
    admits RESUMED: fresh landing pages, one planned ``PageMigration``
    per page (``TickPlan.migrations``), the prefix marked done;
  * with an ``SLOPolicy`` (``serve.slo``) attached: expired best-effort
    waiters shed first, admission runs in (class, arrival) order,
    eviction inverse-priority, and best-effort traffic degrades (chunk
    cap, draft strip) while higher classes have unmet demand.

``Request`` identity is OBJECT identity (``eq=False``).  The scheduler
is host-side and deterministic: the same arrival trace gives the same
plans as the reference scheduler.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

from .kv_cache import PagedKVCache, PageMigration
from .sampling import GREEDY, SamplingParams

# the colocated engine is one PE: migrations land on it, and the prefix
# index names it as every prefix's owner
LOCAL_PE = 0


@dataclasses.dataclass(eq=False)
class Request:
    """One inference request: ``prompt`` token ids, ``max_new`` decode
    budget, ``sampling`` policy.  SLO attributes (``serve.slo``): the
    class ``priority`` orders admission and (inversely) eviction;
    ``deadline`` is the relative TTFT budget in engine clock units,
    attainment's yardstick and best-effort traffic's shed trigger;
    ``tenant`` keys the token-rate fairness bucket."""

    rid: int
    prompt: list
    max_new: int
    t_arrive: float = 0.0
    sampling: SamplingParams = GREEDY
    priority: str = "interactive"
    deadline: Optional[float] = None
    tenant: int = 0

    # runtime (engine-owned)
    out: list = dataclasses.field(default_factory=list)
    n_done: int = 0          # prompt tokens whose KV is in pages
    prefill_chunks: list = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    preemptions: int = 0
    shed: bool = False       # dropped by deadline shedding, never served

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)

    def next_input(self) -> int:
        """The token this sequence feeds next: the prompt while it is
        still being consumed, the last sampled token afterwards."""
        if self.n_done < self.n_prompt:
            return int(self.prompt[self.n_done])
        return int(self.out[-1])

    def is_prefilling(self) -> bool:
        return self.n_done < self.n_prompt

    def finished(self) -> bool:
        return len(self.out) >= self.max_new

    def reset(self) -> None:
        """Preemption: all progress is rebuilt from scratch."""
        self.out.clear()
        self.prefill_chunks.clear()
        self.n_done = 0
        self.preemptions += 1


@dataclasses.dataclass
class TickPlan:
    """What one scheduler tick decided (the engine executes it)."""

    admitted: list = dataclasses.field(default_factory=list)   # fresh
    resumed: list = dataclasses.field(default_factory=list)    # prefix hits
    preempted: list = dataclasses.field(default_factory=list)
    migrations: list = dataclasses.field(default_factory=list)  # PageMigration
    prefill: list = dataclasses.field(default_factory=list)    # (req, n)
    shed: list = dataclasses.field(default_factory=list)       # deadline drops


class FCFSScheduler:
    """First-come-first-served admission over a PagedKVCache.

    ``prefill_chunk`` caps the prompt tokens one sequence consumes per
    tick; ``tick_tokens`` is the per-tick token budget shared by decode
    (claimed first: one token per decoding sequence plus its
    ``draft_allowance`` under speculation) and prefill chunks (FCFS in
    admission order); 0 resolves to ``max_batch * (1 + spec_k) +
    prefill_chunk``.  The oldest prefilling sequence always gets at
    least one token.  ``slo`` attaches an ``SLOPolicy``; None keeps
    plain FCFS, bit for bit."""

    def __init__(self, kv: PagedKVCache, *, max_batch: int,
                 max_seq: int, prefill_chunk: int = 8,
                 tick_tokens: int = 0, spec_k: int = 0, slo=None):
        self.kv = kv
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.spec_k = max(int(spec_k), 0)
        self.tick_tokens = int(tick_tokens) or (
            self.max_batch * (1 + self.spec_k) + self.prefill_chunk)
        self.slo = slo
        self.waiting: deque = deque()
        self.running: list = []          # admission order (oldest first)
        self._decode_refund = 0          # unspent decode claims of
                                         # sequences evicted this tick
        self._admit_seq = itertools.count()
        self._admit_idx: dict = {}       # rid -> admission ticket
        self._arrive_seq = itertools.count()
        self._arrive_idx: dict = {}      # rid -> submission ticket
        self.stats = {"admitted": 0, "resumed": 0, "preempted": 0,
                      "finished": 0, "ticks": 0, "prefill_tokens": 0,
                      "shed": 0, "rate_deferred": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.n_prompt + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: {req.n_prompt}+{req.max_new} tokens "
                f"exceed max_seq {self.max_seq}")
        self._arrive_idx.setdefault(req.rid, next(self._arrive_seq))
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------
    def tick(self, now: float = 0.0) -> TickPlan:
        """One scheduling round: shed expired best-effort waiters (SLO),
        budget the tick's tokens (decode first, then prefill chunks
        FCFS), grow running sequences (preempting by eviction when the
        pool is dry), then admit while slots, pages and budget last —
        prefix-cache hits as RESUMED sequences whose first pages arrive
        by migration."""
        self.stats["ticks"] += 1
        plan = TickPlan()
        if self.slo is not None:
            self._shed_expired(now, plan)
            self.slo.update_pressure(self.waiting, self.running, self.kv)
            self.slo.tick_refill()
        quotas: dict = {}                # rid -> prompt tokens this tick
        budget = self.tick_tokens
        # decode claims first: one token per decoding sequence plus its
        # draft allowance (a verify window spends real forward tokens)
        budget -= sum(1 + self.draft_allowance(r) for r in self.running
                      if not r.is_prefilling())
        for req in self.running:         # admission order = FCFS
            if req.is_prefilling():
                budget = self._grant(req, quotas, budget,
                                     guarantee=not quotas)
        self._decode_refund = 0
        self._ensure_running(plan, quotas)
        # tokens granted to (or claimed by) sequences that eviction just
        # removed are unspent — hand them to this tick's admissions
        for r in plan.preempted:
            budget += quotas.pop(r.rid, 0)
        budget += self._decode_refund
        self._admit(plan, quotas, budget)
        plan.prefill = [(r, quotas[r.rid]) for r in self.running
                        if r.rid in quotas]
        self.stats["prefill_tokens"] += sum(n for _, n in plan.prefill)
        return plan

    def draft_allowance(self, req: Request) -> int:
        """Draft tokens a decoding sequence may carry into this tick's
        verify window: ``spec_k`` capped by the output budget (with
        ``m`` tokens left it can accept at most ``m - 1`` drafts; the
        verify pass itself emits one), 0 while prefilling or when the
        SLO policy strips a degraded sequence's drafts."""
        if self.spec_k == 0 or req.is_prefilling():
            return 0
        if self.slo is not None and self.slo.strip_drafts(req):
            return 0
        return max(0, min(self.spec_k, req.max_new - len(req.out) - 1))

    def _grant(self, req: Request, quotas: dict, budget: int, *,
               guarantee: bool) -> int:
        """Assign ``req`` its chunk for this tick out of ``budget``."""
        chunk = self.prefill_chunk
        if self.slo is not None:
            chunk = self.slo.chunk_cap(req, chunk)
        q = min(chunk, max(budget, 0))
        if guarantee:
            q = max(q, 1)
        q = min(q, req.n_prompt - req.n_done)
        if q > 0:
            quotas[req.rid] = q
        return budget - q

    def _ensure_running(self, plan: TickPlan, quotas: dict) -> None:
        """Every running sequence needs page room for the tokens this
        tick writes.  Out of pages -> evict until it fits."""
        for req in list(self.running):
            if req not in self.running:
                continue                     # evicted by an earlier turn
            # exact demand: prefill covers its chunk quota; decode writes
            # the last sampled token at position n_prompt + len(out) - 1
            # plus one slot per draft its verify window scores
            need = req.n_done + quotas.get(req.rid, 0) \
                if req.is_prefilling() \
                else req.n_prompt + len(req.out) + self.draft_allowance(req)
            while not self.kv.ensure(req.rid, max(need, 1)):
                victim = self._youngest()
                self._preempt(victim, plan)
                if victim is req:
                    break

    def _youngest(self) -> Request:
        """The eviction victim: the youngest admission; under SLO the
        lowest class first, youngest within a class."""
        if self.slo is not None:
            return max(self.running,
                       key=lambda r: self.slo.evict_key(
                           r, self._admit_idx[r.rid]))
        return max(self.running, key=lambda r: self._admit_idx[r.rid])

    def _shed_expired(self, now: float, plan: TickPlan) -> None:
        """Deadline shedding before any admission or degradation this
        tick: waiting best-effort requests past their deadline leave
        without ever holding pages."""
        for req in [r for r in self.waiting
                    if self.slo.should_shed(r, now)]:
            self.waiting.remove(req)     # identity (eq=False)
            req.shed = True
            req.t_finish = now
            plan.shed.append(req)
            self.stats["shed"] += 1
            self.slo.note_shed(req)

    def _preempt(self, req: Request, plan: TickPlan) -> None:
        if not req.is_prefilling():
            # its decode claim (token + draft window) is unspent
            self._decode_refund += 1 + self.draft_allowance(req)
        self.kv.free_seq(req.rid)
        self.running.remove(req)             # identity (eq=False)
        req.reset()
        self.waiting.appendleft(req)         # still ahead of later arrivals
        plan.preempted.append(req)
        self.stats["preempted"] += 1

    def _admission_order(self) -> list:
        """Admission candidates: the waiting line as it is, or under SLO
        by (class rank, arrival) — a preemption victim keeps its arrival
        ticket, so it stays ahead of later arrivals of its class."""
        if self.slo is None:
            return list(self.waiting)
        return sorted(self.waiting,
                      key=lambda r: self.slo.admit_key(
                          r, self._arrive_idx.setdefault(
                              r.rid, next(self._arrive_seq))))

    def _admit(self, plan: TickPlan, quotas: dict, budget: int) -> None:
        preempted_rids = {r.rid for r in plan.preempted}
        for req in self._admission_order():
            if len(self.running) >= self.max_batch:
                break
            if req.rid in preempted_rids:
                # evicted THIS tick: re-admitting now would thrash
                break
            if self.slo is not None and not self.slo.admit_charge(req):
                # tenant over its token rate: ITS request defers, the
                # line behind it does not
                self.stats["rate_deferred"] += 1
                continue
            hit = self.kv.lookup_prefix(req.prompt)
            if hit is not None:
                # same-PE owner: the put_nbi path with self-pairs, a
                # 0-hop page copy into fresh pages (the pinned originals
                # stay in the index)
                if not self._admit_resumed(req, hit, plan):
                    if self.slo is not None:
                        self.slo.admit_refund(req)
                    break
            else:
                # prompt + the first decode page, all or nothing
                if not self.kv.alloc_seq(req.rid, req.n_prompt + 1):
                    if self.slo is not None:
                        self.slo.admit_refund(req)
                    break
                self.waiting.remove(req)     # identity (eq=False)
                self._start(req)
                plan.admitted.append(req)
                self.stats["admitted"] += 1
            budget = self._grant(req, quotas, budget, guarantee=True)

    def _admit_resumed(self, req: Request, hit, plan: TickPlan) -> bool:
        """Take landing pages for the prefix, plan one migration per page,
        and admit with the prefix marked done; the rest of the prompt
        streams through chunked prefill."""
        owner_pe, src_pages = hit
        landing = self.kv.take_pages(len(src_pages))
        if landing is None:
            return False
        self.kv.attach_seq(req.rid, landing)
        if not self.kv.ensure(req.rid, req.n_prompt + 1):
            self.kv.free_seq(req.rid)
            return False
        plan.migrations.extend(
            PageMigration(owner_pe, LOCAL_PE, s, d)
            for s, d in zip(src_pages, landing))
        self.waiting.remove(req)             # identity (eq=False)
        self._start(req)
        # leave >= 1 prompt token to feed: re-feeding the boundary token
        # rewrites identical K/V and yields the next logits
        covered = len(landing) * self.kv.page_tokens
        req.n_done = min(covered, req.n_prompt - 1)
        plan.resumed.append(req)
        self.stats["resumed"] += 1
        self.kv.stats["prefix_hits"] += 1
        return True

    def _start(self, req: Request) -> None:
        self.running.append(req)
        self._admit_idx[req.rid] = next(self._admit_seq)

    # ------------------------------------------------------------------
    def advance(self, req: Request, token: int, now: float = 0.0) -> None:
        """Record one decode step's sampled token for ``req``."""
        if req.is_prefilling():
            self.note_chunk(req, 1, token, now)
        else:
            req.out.append(int(token))

    def note_chunk(self, req: Request, n: int, token: int,
                   now: float = 0.0) -> None:
        """Chunked prefill consumed ``n`` prompt tokens for ``req``; when
        the chunk completes the prompt, ``token`` is its first output."""
        req.n_done += int(n)
        if req.n_done > req.n_prompt:
            raise RuntimeError(
                f"request {req.rid}: prefilled {req.n_done} of "
                f"{req.n_prompt} prompt tokens")
        req.prefill_chunks.append(int(n))
        if not req.is_prefilling():
            req.out.append(int(token))
            req.t_first = now

    def note_prefilled(self, req: Request, first_token: int,
                       now: float = 0.0) -> None:
        """A single chunk consumed the whole remaining prompt at once."""
        self.note_chunk(req, req.n_prompt - req.n_done, first_token, now)

    def finish(self, req: Request, now: float = 0.0,
               register_prefix: bool = True) -> None:
        """Retire ``req``.  With ``register_prefix`` its prompt's full
        pages are published in the prefix index and stay resident (owned
        by the index, not the free list); the rest return to the pool."""
        req.t_finish = now
        self.running.remove(req)             # identity (eq=False)
        if register_prefix:
            pages = self.kv.tables[req.rid]
            n_full = min(len(pages), req.n_prompt // self.kv.page_tokens)
            if n_full and self.kv.register_prefix(req.prompt, LOCAL_PE,
                                                  pages[:n_full]):
                self.kv.tables[req.rid] = pages[n_full:]
        self.kv.free_seq(req.rid)
        self.stats["finished"] += 1
