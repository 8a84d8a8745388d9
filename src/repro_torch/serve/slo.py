"""SLO-aware admission control: priority classes, deadlines, fairness
(the counterpart of ``repro.serve.slo``, pure host code).

Fleet traffic is not uniform: a chat turn (``interactive``) has a
tight time-to-first-token SLO, an offline eval (``batch``) just wants
throughput, and background refills (``best_effort``) exist to soak up
idle capacity.  This module is the policy layer the ``FCFSScheduler``
consults when a :class:`SLOPolicy` is attached:

  * **priority admission** — waiting requests admit in
    (class rank, arrival) order instead of globally FCFS, so an
    interactive arrival never queues behind a best-effort backlog;
  * **inverse-priority preemption** — when the page pool runs dry the
    eviction victim is the lowest class first (best_effort, then
    batch, then interactive), youngest within a class, so load sheds
    *down* the priority ladder ("evict last" for interactive);
  * **deadline shedding** — a waiting best-effort request whose
    deadline has already passed is dropped outright (it could only
    burn pool pages producing an answer nobody will read), BEFORE any
    interactive request is degraded;
  * **degradation under pressure** — while higher classes have unmet
    demand (or the pool is nearly dry), best-effort sequences lose
    their speculative draft allowance and prefill in smaller chunks:
    they keep trickling forward but stop competing for the tick
    budget that protects interactive p99;
  * **per-tenant token-rate fairness** — admission charges a token
    bucket per tenant (refilled ``tenant_rate`` tokens per tick, burst
    capped), so one tenant's flood defers ITS OWN later requests
    instead of starving everyone else's.

The policy is deterministic host-side state, like the scheduler it
advises: the same trace yields the same shed/degrade/admit decisions
on every backend, which keeps the cross-backend stream-parity suites
meaningful under SLO scheduling too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PRIORITIES = ("interactive", "batch", "best_effort")
PRIO_RANK = {p: i for i, p in enumerate(PRIORITIES)}


def rank(priority: str) -> int:
    """Admission/eviction rank of a class (lower admits first,
    higher evicts first)."""
    try:
        return PRIO_RANK[priority]
    except KeyError:
        raise ValueError(f"unknown priority class {priority!r} "
                         f"(want one of {PRIORITIES})") from None


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Policy knobs.  Deadlines/rates are in the engine's clock units
    (ticks under ``clock="tick"``, seconds under ``"wall"``)."""

    # default relative TTFT deadline per class, applied by the traffic
    # generator when a request does not carry its own (None = no SLO)
    ttft_interactive: Optional[float] = None
    ttft_batch: Optional[float] = None
    ttft_best_effort: Optional[float] = None
    # degradation: best-effort prefill chunk cap under pressure, and
    # whether pressure strips best-effort draft allowances
    degrade_chunk: int = 2
    degrade_spec: bool = True
    # pressure = unmet higher-class demand OR free-page fraction below
    # this floor
    pressure_free_frac: float = 0.25
    # per-tenant admission token bucket: ``tenant_rate`` tokens
    # (prompt + decode budget of admitted requests) per tick, holding
    # at most ``tenant_burst`` (0 disables fairness)
    tenant_rate: float = 0.0
    tenant_burst: float = 0.0

    def ttft_target(self, priority: str) -> Optional[float]:
        rank(priority)                    # validate the class name
        return {"interactive": self.ttft_interactive,
                "batch": self.ttft_batch,
                "best_effort": self.ttft_best_effort}[priority]


class SLOPolicy:
    """Mutable per-engine policy state the scheduler consults each
    tick.  All counters live in ``stats`` so the engine's metrics can
    report them."""

    def __init__(self, cfg: Optional[SLOConfig] = None):
        self.cfg = cfg or SLOConfig()
        self.pressure = False
        self._buckets: dict = {}          # tenant -> available tokens
        self.stats = {"shed": 0, "rate_deferred": 0,
                      "degraded_chunks": 0, "degraded_drafts": 0}

    # ------------------------------------------------------------------
    # ordering
    # ------------------------------------------------------------------
    def admit_key(self, req, arrive_seq: int):
        """Sort key for the waiting line: class rank, then arrival."""
        return (rank(req.priority), arrive_seq)

    def evict_key(self, req, admit_idx: int):
        """Sort key for eviction (max wins): lowest class first —
        strictly inverse-priority — youngest within a class."""
        return (rank(req.priority), admit_idx)

    # ------------------------------------------------------------------
    # shedding and degradation
    # ------------------------------------------------------------------
    def should_shed(self, req, now: float) -> bool:
        """Drop a WAITING request whose deadline already passed.  Only
        best-effort traffic sheds — higher classes keep their place
        (a missed deadline there shows up in attainment, the signal
        the operator actually pages on)."""
        return (req.priority == "best_effort"
                and req.deadline is not None
                and now - req.t_arrive > req.deadline)

    def note_shed(self, req) -> None:
        self.stats["shed"] += 1

    def update_pressure(self, waiting, running, kv) -> bool:
        """Recompute the tick's pressure signal: any waiting request of
        a class above best_effort (unmet higher-class demand), or a
        nearly-dry page pool."""
        hi = any(rank(r.priority) < PRIO_RANK["best_effort"]
                 for r in waiting)
        free_frac = kv.n_free() / max(kv.n_pages - 1, 1)
        self.pressure = bool(hi or free_frac < self.cfg.pressure_free_frac)
        return self.pressure

    def chunk_cap(self, req, prefill_chunk: int) -> int:
        """Prefill chunk for ``req`` this tick: best-effort shrinks to
        ``degrade_chunk`` under pressure, everyone else keeps the
        configured chunk."""
        if self.pressure and req.priority == "best_effort" \
                and self.cfg.degrade_chunk < prefill_chunk:
            self.stats["degraded_chunks"] += 1
            return max(int(self.cfg.degrade_chunk), 1)
        return prefill_chunk

    def strip_drafts(self, req) -> bool:
        """Under pressure a best-effort sequence loses its speculative
        draft allowance (its verify window collapses to plain decode),
        returning that tick budget to interactive traffic."""
        if self.pressure and self.cfg.degrade_spec \
                and req.priority == "best_effort":
            self.stats["degraded_drafts"] += 1
            return True
        return False

    # ------------------------------------------------------------------
    # per-tenant token-rate fairness
    # ------------------------------------------------------------------
    @property
    def fairness_on(self) -> bool:
        return self.cfg.tenant_rate > 0

    def tick_refill(self) -> None:
        if not self.fairness_on:
            return
        burst = self.cfg.tenant_burst or self.cfg.tenant_rate
        for t in list(self._buckets):
            self._buckets[t] = min(self._buckets[t] + self.cfg.tenant_rate,
                                   burst)

    def _bucket(self, tenant) -> float:
        burst = self.cfg.tenant_burst or self.cfg.tenant_rate
        return self._buckets.setdefault(tenant, burst)

    def admit_charge(self, req) -> bool:
        """Charge ``req``'s token footprint (prompt + decode budget) to
        its tenant's bucket; False defers the request this tick WITHOUT
        blocking other tenants behind it."""
        if not self.fairness_on:
            return True
        cost = req.n_prompt + req.max_new
        if self._bucket(req.tenant) < cost:
            self.stats["rate_deferred"] += 1
            return False
        self._buckets[req.tenant] -= cost
        return True

    def admit_refund(self, req) -> None:
        """Undo an ``admit_charge`` whose admission then failed on
        pages/slots (the tokens were never served)."""
        if self.fairness_on:
            self._buckets[req.tenant] = \
                self._bucket(req.tenant) + req.n_prompt + req.max_new

    def reset(self) -> None:
        for k in self.stats:
            self.stats[k] = 0
        self._buckets.clear()
        self.pressure = False
