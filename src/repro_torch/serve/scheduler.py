"""FCFS continuous batching with preempt-by-eviction and token-budgeted
chunked prefill — the counterpart of ``repro.serve.scheduler`` without
the SLO policy, prefix-cache resumes and disaggregated handoff (later
slices of the port).

  * requests queue FCFS; a request is ADMITTED when a batch slot is
    free and the pool can cover its prompt + one decode page;
  * every engine tick decodes ONE token for every decoding sequence,
    and hands every PREFILLING sequence up to ``prefill_chunk`` prompt
    tokens, under one shared per-tick token budget (``tick_tokens``) —
    decode claims its tokens first;
  * when a sequence needs a page and the pool is dry, the YOUNGEST
    running sequence is preempted by eviction: its pages are freed and
    it re-queues at the head of the line to re-prefill later.

``Request`` identity is OBJECT identity (``eq=False``).  The scheduler
is host-side and deterministic: the same arrival trace gives the same
plans as the reference scheduler.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

from .kv_cache import PagedKVCache
from .sampling import GREEDY, SamplingParams


@dataclasses.dataclass(eq=False)
class Request:
    """One inference request: ``prompt`` token ids, ``max_new`` decode
    budget, ``sampling`` policy.  The SLO attributes are carried so that
    traces match the reference's; the SLO policy that reads them is a
    later slice."""

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

    admitted: list = dataclasses.field(default_factory=list)
    preempted: list = dataclasses.field(default_factory=list)
    prefill: list = dataclasses.field(default_factory=list)   # (req, n)


class FCFSScheduler:
    """First-come-first-served admission over a PagedKVCache.

    ``prefill_chunk`` caps the prompt tokens one sequence consumes per
    tick; ``tick_tokens`` is the per-tick token budget shared by decode
    (claimed first) and prefill chunks (FCFS in admission order); 0
    resolves to ``max_batch + prefill_chunk``.  The oldest prefilling
    sequence always gets at least one token."""

    def __init__(self, kv: PagedKVCache, *, max_batch: int,
                 max_seq: int, prefill_chunk: int = 8,
                 tick_tokens: int = 0):
        self.kv = kv
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.tick_tokens = int(tick_tokens) or (
            self.max_batch + self.prefill_chunk)
        self.waiting: deque = deque()
        self.running: list = []          # admission order (oldest first)
        self._decode_refund = 0          # unspent decode claims of
                                         # sequences evicted this tick
        self._admit_seq = itertools.count()
        self._admit_idx: dict = {}       # rid -> admission ticket
        self.stats = {"admitted": 0, "preempted": 0, "finished": 0,
                      "ticks": 0, "prefill_tokens": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.n_prompt + req.max_new > self.max_seq:
            raise ValueError(
                f"request {req.rid}: {req.n_prompt}+{req.max_new} tokens "
                f"exceed max_seq {self.max_seq}")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------------
    def tick(self, now: float = 0.0) -> TickPlan:
        """One scheduling round: budget the tick's tokens (decode first,
        then prefill chunks FCFS), grow running sequences (preempting by
        eviction when the pool is dry), then admit FCFS while slots,
        pages and budget last."""
        self.stats["ticks"] += 1
        plan = TickPlan()
        quotas: dict = {}                # rid -> prompt tokens this tick
        budget = self.tick_tokens
        budget -= sum(1 for r in self.running if not r.is_prefilling())
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

    def _grant(self, req: Request, quotas: dict, budget: int, *,
               guarantee: bool) -> int:
        """Assign ``req`` its chunk for this tick out of ``budget``."""
        q = min(self.prefill_chunk, max(budget, 0))
        if guarantee:
            q = max(q, 1)
        q = min(q, req.n_prompt - req.n_done)
        if q > 0:
            quotas[req.rid] = q
        return budget - q

    def _ensure_running(self, plan: TickPlan, quotas: dict) -> None:
        """Every running sequence needs page room for the tokens this
        tick writes.  Out of pages -> evict the youngest until it fits."""
        for req in list(self.running):
            if req not in self.running:
                continue                     # evicted by an earlier turn
            # exact demand: prefill covers its chunk quota; decode writes
            # the last sampled token at position n_prompt + len(out) - 1
            need = req.n_done + quotas.get(req.rid, 0) \
                if req.is_prefilling() else req.n_prompt + len(req.out)
            while not self.kv.ensure(req.rid, max(need, 1)):
                victim = max(self.running,
                             key=lambda r: self._admit_idx[r.rid])
                self._preempt(victim, plan)
                if victim is req:
                    break

    def _preempt(self, req: Request, plan: TickPlan) -> None:
        if not req.is_prefilling():
            self._decode_refund += 1     # its decode claim is unspent
        self.kv.free_seq(req.rid)
        self.running.remove(req)             # identity (eq=False)
        req.reset()
        self.waiting.appendleft(req)         # still ahead of later arrivals
        plan.preempted.append(req)
        self.stats["preempted"] += 1

    def _admit(self, plan: TickPlan, quotas: dict, budget: int) -> None:
        preempted_rids = {r.rid for r in plan.preempted}
        for req in list(self.waiting):
            if len(self.running) >= self.max_batch:
                break
            if req.rid in preempted_rids:
                # evicted THIS tick: re-admitting now would thrash
                break
            # prompt + the first decode page, all or nothing
            if not self.kv.alloc_seq(req.rid, req.n_prompt + 1):
                break
            self.waiting.remove(req)         # identity (eq=False)
            self.running.append(req)
            self._admit_idx[req.rid] = next(self._admit_seq)
            plan.admitted.append(req)
            self.stats["admitted"] += 1
            budget = self._grant(req, quotas, budget, guarantee=True)

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

    def finish(self, req: Request, now: float = 0.0) -> None:
        req.t_finish = now
        self.running.remove(req)             # identity (eq=False)
        self.kv.free_seq(req.rid)
        self.stats["finished"] += 1
