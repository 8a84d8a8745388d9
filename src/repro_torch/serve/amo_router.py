"""AMO-arbitrated cell routing: admission rings and load words on the
symmetric heap — the counterpart of ``repro.serve.amo_router``.

:class:`~repro_torch.serve.disagg.CellRouter` is host-serial: every
routing decision reads every cell's scheduler through Python objects.
This router moves the routing STATE onto symmetric counter words (one
word row per cell rank) and every transition onto queue AMOs on the
``router`` CommQueue:

  * **admission** — each prefill cell owns a CAS head/tail ticket ring:
    ``submit`` publishes a request id into the least-loaded cell's ring
    (``fadd`` the tail ticket, ``swap`` the slot, ``fadd`` the load word
    by the prompt tokens); each tick the cell CAS-claims from its own
    head up to its admission capacity;
  * **work stealing** — a cell with spare capacity and a dry ring
    CAS-claims from the most-backlogged victim's head (the same
    ``cswap`` pop; counted in ``stats['steals']``);
  * **handoff routing** — decode cells publish their live-sequence count
    to a load word at the end of each tick; producers pick the decode
    cell by fetching load + inbound words, and inbound tracking is
    ``fadd`` on ticket issue / adopt.

With no stealing, the word values a ``submit`` or ``route_handoff``
fetches equal what the host router reads from the schedulers at the same
point of the tick, so the two routers place identically; a steal may
move a request between cells, and its stream still does not change
(sampling is keyed ``(rid, position, sample_seed)``).

The words are host control state, a CPU int64 tensor as the reference's
numpy words are: no AMO waits on the device.  Every AMO drains by
``amo_wait`` on its own word (``queue_stats()['quiets'] == 0``).
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import torch

from repro_torch.core.heap import SymmetricHeap
from repro_torch.core.ordering import CommQueue, LocalTransport
from repro_torch.core.signals import SignalPad

from .disagg import CellRouter, CellSpec
from .scheduler import Request

# per-cell word layout (one row of the router words object per rank)
W_ADM_HEAD = 0       # ring consume ticket (CAS-claimed)
W_ADM_TAIL = 1       # ring publish ticket (fetch-add)
W_ADM_LOAD = 2       # queued prompt tokens (routing key, prefill cells)
W_DEC_LOAD = 3       # live decode sequences (republished per tick)
W_DEC_INBOUND = 4    # issued-but-unadopted handoff tickets
W_RING = 5           # ring slots: rid + 1 (0 = empty)


class AmoCellRouter(CellRouter):
    """Work-stealing admission and handoff routing on symmetric words:
    :class:`CellRouter`'s ``route_handoff`` surface plus the AMO
    admission path (``submit`` / ``admit``) ``DisaggEngine`` drives in
    ``router="amo"`` mode."""

    def __init__(self, engines: Sequence, cells: Sequence[CellSpec], *,
                 delivery_seed=0):
        super().__init__(engines, cells)
        mb = max(e.scfg.max_batch for e in self.engines)
        self.n_ring = max(4 * mb, 32)
        n_cells = len(self.cells)
        heap = SymmetricHeap(("router",))
        self.pad = SignalPad(heap, W_RING + self.n_ring, name="router_words")
        state = {self.pad.handle.name:
                 torch.zeros((n_cells, self.pad.n), dtype=torch.int64)}
        self.q = CommQueue("router", state,
                           transport=LocalTransport(n_cells),
                           delivery_seed=delivery_seed)
        self._reqs: dict = {}              # rid -> unclaimed Request
        self._spill = {c: deque() for c in self.prefill}
        self._pub_load = {c: 0 for c in self.prefill}
        self.stats = {"steals": 0, "adm_published": 0, "adm_claimed": 0,
                      "adm_spilled": 0, "cas_retries": 0}

    # ------------------------------------------------------------------
    def _amo(self, op: str, word: int, cell: int, value=None,
             cond=None) -> int:
        v = self.q.amo_nbi(  # shmem: deferred-drain
            self.pad.handle, op, [(int(cell), int(cell))], value=value,
            cond=cond, offset=int(word))
        self.q.amo_wait(self.pad.handle, offset=int(word))
        return int(v.value())

    # ------------------------------------------------------------------
    # admission: publish -> (per tick) claim + steal
    # ------------------------------------------------------------------
    def adm_load(self, cell: int) -> int:
        return self._amo("fetch", W_ADM_LOAD, cell)

    def submit(self, req: Request) -> None:
        """Publish ``req`` into the least-loaded prefill cell's ring.  The
        request stays host-resident keyed by rid; the ring carries only
        the id, and whichever cell wins the claim CAS owns it."""
        c = min(self.prefill, key=lambda c: (self.adm_load(c), c))
        self._reqs[req.rid] = req
        if not self._ring_push(c, req):
            self._spill[c].append(req)     # ring full: host-side spill,
            self.stats["adm_spilled"] += 1  # re-published next tick

    def _ring_push(self, cell: int, req: Request) -> bool:
        head = self._amo("fetch", W_ADM_HEAD, cell)
        tail = self._amo("fetch", W_ADM_TAIL, cell)
        if tail - head >= self.n_ring:
            return False
        t = self._amo("fadd", W_ADM_TAIL, cell, 1)
        self._amo("swap", W_RING + t % self.n_ring, cell, req.rid + 1)
        self._amo("fadd", W_ADM_LOAD, cell, req.n_prompt)
        self.stats["adm_published"] += 1
        return True

    def _ring_pop(self, cell: int) -> Optional[Request]:
        """CAS-claim one request off ``cell``'s ring head (a claim and a
        steal are the same operation; only the caller differs)."""
        while True:
            head = self._amo("fetch", W_ADM_HEAD, cell)
            tail = self._amo("fetch", W_ADM_TAIL, cell)
            if head == tail:
                return None
            old = self._amo("cswap", W_ADM_HEAD, cell, value=head + 1,
                            cond=head)
            if old != head:
                self.stats["cas_retries"] += 1
                continue
            rid = self._amo("swap", W_RING + head % self.n_ring, cell, 0) - 1
            req = self._reqs.pop(rid)
            self._amo("fadd", W_ADM_LOAD, cell, -req.n_prompt)
            return req

    def _capacity(self, cell: int) -> int:
        e = self.engines[cell]
        return max(0, e.scfg.max_batch
                   - len(e.sched.running) - len(e.sched.waiting))

    def admit(self) -> None:
        """One admission round (engine tick start): each cell re-publishes
        its spill and claims from its own ring up to capacity, then cells
        with spare capacity steal from the most-backlogged ring."""
        for c in self.prefill:
            spill = self._spill[c]
            while spill and self._ring_push(c, spill[0]):
                spill.popleft()
            cap = self._capacity(c)
            while cap > 0:
                req = self._ring_pop(c)
                if req is None:
                    break
                self.engines[c].submit(req)
                self.stats["adm_claimed"] += 1
                cap -= 1
        for c in self.prefill:
            cap = self._capacity(c)
            while cap > 0:
                victims = [v for v in self.prefill if v != c
                           and self._backlog(v) > 0]
                if not victims:
                    break
                v = max(victims, key=lambda v: (self._backlog(v), -v))
                req = self._ring_pop(v)
                if req is None:
                    break
                self.engines[c].submit(req)
                self.stats["steals"] += 1
                self.stats["adm_claimed"] += 1
                cap -= 1

    def _backlog(self, cell: int) -> int:
        return (self._amo("fetch", W_ADM_TAIL, cell)
                - self._amo("fetch", W_ADM_HEAD, cell))

    def pending(self) -> int:
        """Published-but-unclaimed requests (a run loop must not stop
        while any remain)."""
        return len(self._reqs)

    # ------------------------------------------------------------------
    # load republication (tick end) + handoff routing
    # ------------------------------------------------------------------
    def publish_loads(self) -> None:
        """Fold each cell's scheduler state into its word: the prefill
        load word tracks the local load's delta (unclaimed ring entries
        keep their own fadd contributions); the decode load word is a
        plain republish."""
        for c in self.prefill:
            local = super().prefill_load(c)
            delta = local - self._pub_load[c]
            if delta:
                self._amo("fadd", W_ADM_LOAD, c, delta)
                self._pub_load[c] = local
        for c in self.decode:
            self._amo("swap", W_DEC_LOAD, c,
                      len(self.engines[c].sched.running))

    def decode_load(self, cell: int) -> int:
        return (self._amo("fetch", W_DEC_LOAD, cell)
                + self._amo("fetch", W_DEC_INBOUND, cell))

    def inbound_add(self, cell: int, delta: int) -> None:
        self.inbound[cell] += delta        # keep the host view coherent
        self._amo("fadd", W_DEC_INBOUND, cell, delta)

    def queue_stats(self) -> dict:
        """Router-queue counters (``quiets == 0`` is pinned)."""
        return self.q.stats()
