"""Disaggregated prefill/decode serving cells with put-with-signal page
handoff — the counterpart of ``repro.serve.disagg``.

Colocated continuous batching (``ServeEngine``) makes every decode tick
share its batch with prefill chunks.  Disaggregation (DistServe /
Splitwise / Mooncake) splits the topology into PREFILL cells and DECODE
cells: prompts burn their compute on cells that decode never sees, and
finished prefills move their KV pages to a decode cell once.

Each move is a *ticket*: the producer streams the sequence's pages into
the consumer cell's mailbox with ``put_signal_nbi`` (every page guarded
by the ticket's signal word, one word per ticket from a
:class:`~repro_torch.core.signals.SignalPad`), and the consumer adopts
the sequence once ``signal_wait_until`` on that word returns — a
per-transfer drain that retires ONLY this ticket's pages.  No cell
issues a tick-global quiet for handoff traffic (``handoff_quiets ==
0``).

Topology is host-side and explicit:

  * :class:`CellRouter` admits each prompt to the least-loaded prefill
    cell (queued prompt tokens) and hands each sequence to the
    least-loaded decode cell (live + inbound sequences);
    ``router="amo"`` swaps in ``serve.amo_router.AmoCellRouter``
    (CAS admission rings, work stealing, load words) and a
    ``serve.page_pool.SymmetricPagePool`` behind every cell's cache;
  * :class:`DisaggEngine` holds one ``ServeEngine`` per cell
    (``role="prefill"`` / ``"decode"``) over ONE weights dict — the
    cells share the parameters, never copy them — with cell PE ids
    carved from the flat PE space by ``core.teams.ActiveSet``, and ONE
    persistent handoff ``CommQueue`` over the cell space.

Placement.  The mailbox ``kv_mail`` (``(n_decode, n_pages,
*page_row)``, the pool geometry, one row block per decode cell: a
prefill cell never receives) lives on the serving device beside the
pools, and a handoff is device copies only, each page row copied three
times: the producer's pool row -> the put's issue-time snapshot (local
completion) -> the consumer's mailbox row -> the consumer's pool row.
Its queue lands each put in the mailbox in place (no copy of the
mailbox per put), and a put's payload is the source cell's row alone,
``(1, 1, *page_row)``: a one-sided put carries what its source holds.
The signal words, the mailbox claim words, the page-pool words and the
router words are host control state, CPU int64 tensors, as the
reference keeps them in numpy: a wait or an AMO reads its word with no
device synchronization.

Token streams do not depend on the topology: sampling is keyed ``(rid,
position)`` off ``ServeConfig.sample_seed``, so a sequence decoded on
another cell, in whatever batch, draws the colocated engine's tokens.

Weight hot-swap over the cell space (``begin_hot_swap``): ONE
``ckpt.hotswap.WeightStreamer`` with a PE per cell streams the new
generation between topology ticks, and on the flip tick every cell's
``exec.set_params`` gets the same reassembled dict before any cell
steps: the cells keep sharing one weights dict, and none keeps the old
tensors.

Tensor-parallel cells (``ctx.tp_size > 1``: each cell one TP group, the
reference's ``make_cells(..., pes_per_cell=TP)``): every cell's engine
gets a one-replica ``engine.StackedExec``, all of them over ONE stacked
weights dict (stacked here once, never per cell), and the mailbox
carries each page as its TP shards, ``(TP, *page_row)`` a row.  There
is still one ``signal_wait_until`` per ticket and no quiet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.heap import SymmetricHeap
from repro_torch.core.ordering import CommQueue, InPlaceTransport
from repro_torch.core.signals import CMP_EQ, SignalPad
from repro_torch.core.teams import ActiveSet
from repro_torch.parallel import ParallelCtx
from repro_torch.weights import shard_for_tp

from repro_torch.ckpt.hotswap import WeightStreamer

from .engine import (ServeConfig, ServeEngine, _check_supported,
                     add_swap_stats, reset_swap_stats, slo_summary)
from .scheduler import Request


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One serving cell: its index in the cell space, its role, and the
    PE ids (flat numbering) it owns — an OpenSHMEM active set, so a 2-PE
    cell is ``stride 1, size 2``."""

    cell: int
    role: str                      # "prefill" | "decode"
    pes: tuple[int, ...]


def make_cells(n_prefill: int, n_decode: int,
               pes_per_cell: int = 1) -> list[CellSpec]:
    """Carve ``n_prefill + n_decode`` cells out of the flat PE space,
    prefill cells first, each owning ``pes_per_cell`` consecutive PEs
    (``ActiveSet(start=cell * pes_per_cell, size=pes_per_cell)``)."""
    if n_prefill < 1 or n_decode < 1:
        raise ValueError("need at least one prefill and one decode cell")
    cells = []
    for c in range(n_prefill + n_decode):
        aset = ActiveSet(start=c * pes_per_cell, size=pes_per_cell)
        role = "prefill" if c < n_prefill else "decode"
        cells.append(CellSpec(c, role, tuple(aset.pes())))
    return cells


@dataclasses.dataclass
class HandoffTicket:
    """One in-flight prefill -> decode page handoff."""

    ticket: int                    # unique id; signal value = ticket + 1
    req: Request
    src_cell: int
    dst_cell: int
    src_pages: list                # producer-pool page ids (resident)
    dst_pages: list                # consumer-pool landing page ids
    word: int                      # SignalPad offset guarding the ticket


class CellRouter:
    """Host-side admission and handoff routing across cells.

    Least-loaded placement on both sides: prompts go to the prefill cell
    with the fewest QUEUED PROMPT TOKENS still to compute, handoffs to
    the decode cell with the fewest LIVE + INBOUND sequences.  Ties break
    to the lowest cell index, so routing is deterministic for a trace."""

    def __init__(self, engines: Sequence[ServeEngine],
                 cells: Sequence[CellSpec]):
        self.engines = list(engines)
        self.cells = list(cells)
        self.prefill = [c.cell for c in cells if c.role == "prefill"]
        self.decode = [c.cell for c in cells if c.role == "decode"]
        self.inbound = {c: 0 for c in self.decode}   # undelivered tickets

    def prefill_load(self, cell: int) -> int:
        e = self.engines[cell]
        return (sum(r.n_prompt for r in e.sched.waiting)
                + sum(r.n_prompt - r.n_done for r in e.sched.running
                      if r.is_prefilling()))

    def decode_load(self, cell: int) -> int:
        return len(self.engines[cell].sched.running) + self.inbound[cell]

    def route_prompt(self, req: Request) -> int:
        return min(self.prefill, key=lambda c: (self.prefill_load(c), c))

    def route_handoff(self, req: Request) -> Optional[int]:
        """The decode cell that will own ``req``, or None when every
        decode cell's batch (live + inbound) is full: backpressure, the
        producer keeps the sequence parked with its pages resident."""
        c = min(self.decode, key=lambda c: (self.decode_load(c), c))
        if self.decode_load(c) >= self.engines[c].scfg.max_batch:
            return None
        return c

    def inbound_add(self, cell: int, delta: int) -> None:
        """Inbound-ticket accounting (the AMO router makes it a ``fadd``
        on the cell's inbound word)."""
        self.inbound[cell] += delta


class DisaggEngine:
    """P prefill + D decode ``ServeEngine`` cells behind one submit/run
    interface, handing sequences off through a put-with-signal mailbox.

    The mailbox is a persistent :class:`CommQueue` over the CELL space:
    one symmetric ``kv_mail`` object mirroring the pool geometry plus a
    :class:`SignalPad` of ticket words.  Producers ``put_signal_nbi``
    each exported page into the consumer's mailbox rows at the LANDING
    page ids (carved by ``PagedKVCache.adopt_seq``: the block-table
    remap); the consumer drains with ONE ``signal_wait_until`` per
    ticket, copies the landed rows into its pool, and acknowledges, so
    the producer frees its source pages.  ``device=None`` is the GPU
    (tests pass ``device="cpu"``).  ``ctx`` (default: tp = 1) sets the
    cells' TP size: a cell is one TP group of ``ctx.tp_size`` PEs."""

    def __init__(self, params, cfg, scfg: ServeConfig, *, ctx=None,
                 device=None, n_prefill: int = 1, n_decode: int = 1,
                 delivery_seed: Optional[int] = 0,
                 router: str = "host"):
        if router not in ("host", "amo"):
            raise ValueError(f"router must be 'host' or 'amo', "
                             f"got {router!r}")
        self.cfg = cfg
        self.ctx = ParallelCtx() if ctx is None else ctx
        _check_supported(cfg, self.ctx)
        self.scfg = scfg
        self.router_mode = router
        self.cells = make_cells(n_prefill, n_decode, self.ctx.tp_size)
        n_cells = len(self.cells)
        # one weights dict for every cell: shared, never copied (stacked
        # for TP once, here)
        params = shard_for_tp(params, cfg, self.ctx.tp_size)
        self.engines = [
            ServeEngine(params, cfg, scfg, ctx=self.ctx, device=device,
                        role=c.role, my_pe=c.pes[0])
            for c in self.cells
        ]
        self.device = self.engines[0].device
        self.pools: list = []
        if router == "amo":
            # the whole control plane goes lock-free: CAS-arbitrated
            # admission and handoff routing AND a symmetric page pool
            # behind every cell's allocator (the same grant order, so
            # token streams cannot move)
            from .amo_router import AmoCellRouter
            from .page_pool import SymmetricPagePool
            self.router = AmoCellRouter(self.engines, self.cells,
                                        delivery_seed=delivery_seed)
            for i, e in enumerate(self.engines):
                pool = SymmetricPagePool(e.kv.n_pages,
                                         delivery_seed=delivery_seed,
                                         name=f"pool_words_{i}")
                e.kv.attach_pool(pool)
                self.pools.append(pool)
        else:
            self.router = CellRouter(self.engines, self.cells)

        # the handoff mailbox: symmetric objects over the cell space.  The
        # page-row shape comes from the exec substrate
        e0 = self.engines[0]
        row0 = e0.exec.read_pages(e0.pool, [0])[0]
        mail_heap = SymmetricHeap(("cells",))
        self._kv_mail = mail_heap.alloc(
            "kv_mail", (e0.kv.n_pages,) + tuple(row0.shape[1:]), row0.dtype)
        n_words = max(2 * scfg.max_batch, 4)
        self.pad = SignalPad(mail_heap, n_words)
        # mailbox-slot claim words (the same carve as the signal pad): in
        # AMO mode a producer owns word w of a consumer's pad iff it won
        # cswap(claim[w], 0 -> ticket+1) on that cell
        self._claim = SignalPad(mail_heap, n_words, name="mail_claim")
        # KV rows only on the decode cells: a prefill cell never receives
        self._mail_state = {
            "kv_mail": torch.zeros((n_decode,) + self._kv_mail.shape,
                                   dtype=self._kv_mail.dtype,
                                   device=row0.device),
            self.pad.handle.name:
                torch.zeros((n_cells, self.pad.n), dtype=torch.int64),
            self._claim.handle.name:
                torch.zeros((n_cells, self._claim.n), dtype=torch.int64),
        }
        del row0
        self.hq = CommQueue("cells", self._mail_state,
                            transport=InPlaceTransport(n_cells, n_prefill),
                            delivery_seed=delivery_seed)
        # a ticket word is reused only after its ticket was adopted — per
        # consumer cell, so concurrent handoffs never share a word
        self._free_words = {c: deque(range(self.pad.n))
                            for c in self.router.decode}
        self._inbox = {c: deque() for c in self.router.decode}
        self._tickets = 0
        self.ticks = 0
        self.handoff = {"handoff_tickets": 0, "handoff_pages": 0,
                        "handoff_deferred": 0}
        # weight hot-swap: ONE streamer spans the cell space, so every cell
        # flips to the new generation on the same topology tick
        self._swap = None
        self.swap_stats = {"generation": 0, "flips": 0, "swap_ticks": 0,
                           "swap_batches": 0, "swap_bytes": 0,
                           "swap_extra_quiets": 0}

    # ------------------------------------------------------------------
    @property
    def finished(self) -> list:
        out = []
        for e in self.engines:
            out.extend(e.finished)
        return out

    def has_work(self) -> bool:
        return (any(e.sched.has_work() for e in self.engines)
                or any(e.handoff_ready for e in self.engines)
                or any(self._inbox.values())
                or self._swap is not None
                or (self.router_mode == "amo"
                    and self.router.pending() > 0))

    def begin_hot_swap(self, new_params, *, chunk_rows: int = 4,
                       row_bytes: int = 1 << 14) -> None:
        """Zero-downtime weight swap across the whole topology: one
        ``WeightStreamer`` over the CELL space (a PE per cell) streams
        the new generation between topology ticks; on the flip tick
        every cell's weights switch together."""
        if self._swap is not None:
            raise RuntimeError("a weight hot-swap is already in flight")
        self.swap_stats["generation"] += 1
        self._swap = WeightStreamer(
            new_params, n_pe=len(self.cells),
            generation=self.swap_stats["generation"],
            chunk_rows=chunk_rows, row_bytes=row_bytes, device=self.device)

    def swap_in_flight(self) -> bool:
        return self._swap is not None

    def _swap_step(self) -> None:
        st = self._swap
        if not st.step():
            return
        params = shard_for_tp(st.result(), self.cfg, self.ctx.tp_size)
        for e in self.engines:           # same tick, every cell
            e.exec.set_params(params)
        self._swap = None
        add_swap_stats(self.swap_stats, st)

    def submit(self, req: Request) -> None:
        if self.router_mode == "amo":
            # publish into an admission ring; a cell claims it by CAS at
            # the next tick (same-tick admission, like host mode)
            self.router.submit(req)
        else:
            self.engines[self.router.route_prompt(req)].submit(req)

    # ------------------------------------------------------------------
    def tick(self, now: float = 0.0) -> None:
        """One topology tick: prefill cells advance, finished prefills
        ticket out (put-with-signal per page), decode cells drain their
        inbox on signal fire, adopt, acknowledge, then advance."""
        self.ticks += 1
        if self._swap is not None:
            self._swap_step()
        if self.router_mode == "amo":
            self.router.admit()
        for c in self.router.prefill:
            e = self.engines[c]
            if e.sched.has_work():
                e.tick(now)
        for c in self.router.prefill:
            self._issue_handoffs(c)
        for c in self.router.decode:
            self._drain_inbox(c, now)
            e = self.engines[c]
            if e.sched.has_work():
                e.tick(now)
        if self.router_mode == "amo":
            self.router.publish_loads()

    def _claim_word(self, cell: int) -> Optional[int]:
        """Claim a free mailbox word on ``cell``.  Host mode pops the FIFO
        recycle deque; AMO mode scans the claim words and owns the first
        one it wins with ``cswap(0 -> ticket+1)``."""
        if self.router_mode != "amo":
            fw = self._free_words[cell]
            return fw.popleft() if fw else None
        for w in range(self._claim.n):
            old = self.hq.amo_nbi(  # shmem: deferred-drain
                self._claim.handle, "cswap", [(cell, cell)],
                value=self._tickets + 1, cond=0, offset=w)
            self.hq.amo_wait(self._claim.handle, offset=w)
            if int(old.value()) == 0:
                return w
        return None

    def _release_word(self, cell: int, word: int, *,
                      to_front: bool = False) -> None:
        """Return a mailbox word: AMO mode clears the claim word (an
        atomic swap); host mode requeues — ``to_front`` restores a claim
        rolled back before use."""
        if self.router_mode == "amo":
            self.hq.amo_nbi(  # shmem: deferred-drain
                self._claim.handle, "swap", [(cell, cell)], value=0,
                offset=word)
            self.hq.amo_wait(self._claim.handle, offset=word)
        elif to_front:
            self._free_words[cell].appendleft(word)
        else:
            self._free_words[cell].append(word)

    def _issue_handoffs(self, src_cell: int) -> None:
        src = self.engines[src_cell]
        parked = []
        while src.handoff_ready:
            req = src.handoff_ready.pop(0)
            dst_cell = self.router.route_handoff(req)
            word = None if dst_cell is None else self._claim_word(dst_cell)
            if word is None:
                # backpressure: every decode batch (or the word pad) is
                # full; the sequence stays parked, its pages resident
                parked.append(req)
                self.handoff["handoff_deferred"] += 1
                continue
            src_pages = src.kv.export_seq(req.rid)
            dst_pages = self.engines[dst_cell].kv.adopt_seq(
                req.rid, len(src_pages))
            if dst_pages is None:            # consumer pool dry
                src.kv.attach_seq(req.rid, src_pages)
                src.kv.stats["exported_pages"] -= len(src_pages)
                self._release_word(dst_cell, word, to_front=True)
                parked.append(req)
                self.handoff["handoff_deferred"] += 1
                continue
            t = HandoffTicket(self._tickets, req, src_cell, dst_cell,
                              src_pages, dst_pages, word)
            self._tickets += 1
            self._put_pages(t)
            self.router.inbound_add(dst_cell, 1)
            self._inbox[dst_cell].append(t)
            self.handoff["handoff_tickets"] += 1
            self.handoff["handoff_pages"] += len(src_pages)
        src.handoff_ready.extend(parked)

    def _put_pages(self, t: HandoffTicket) -> None:
        """Stream one ticket's pages: each page is a put-with-signal into
        the consumer's mailbox at its LANDING page id, all guarded by the
        ticket's word (SIGNAL_SET of ``ticket + 1``: the same value per
        page, so the settled word does not depend on delivery order)."""
        src = self.engines[t.src_cell]
        rows = src.exec.read_pages(src.pool, t.src_pages)
        pairs = [(t.src_cell, t.dst_cell)]
        for row, dp in zip(rows, t.dst_pages):
            # the put's issue-time snapshot is the one copy of the source
            # row; drained per transfer by _drain_inbox's signal_wait_until
            self.hq.put_signal_nbi(  # shmem: deferred-drain
                self._kv_mail, row[None], pairs, self.pad.handle,
                t.ticket + 1, offset=dp, sig_offset=t.word)

    def _drain_inbox(self, cell: int, now: float) -> None:
        """Adopt every deliverable ticket: ONE ``signal_wait_until`` on
        the ticket's word retires exactly its pages (never a quiet), the
        landed rows are copied into the cell's pool, and the producer is
        acknowledged (it frees its source pages; the word recycles)."""
        dst = self.engines[cell]
        inbox = self._inbox[cell]
        while inbox:
            t = inbox[0]
            st = self.hq.signal_wait_until(
                self.pad.handle, CMP_EQ, t.ticket + 1,
                sig_offset=t.word, pe=cell)
            inbox.popleft()
            mail = st["kv_mail"][cell - len(self.router.prefill)]
            dst.pool = dst.exec.write_pages(
                dst.pool, t.dst_pages, [mail[p:p + 1] for p in t.dst_pages])
            dst.adopt_request(t.req, dst.kv.tables.pop(t.req.rid), now)
            # ack: the producer's copy served its purpose
            self.engines[t.src_cell].kv.release_pages(t.src_pages)
            self.router.inbound_add(cell, -1)
            # the word recycles only once its ticket is retired, zeroed
            # THROUGH the queue (signal_reset), not behind its back
            self.hq.signal_reset(self.pad.handle, [(cell, cell)],
                                 sig_offset=t.word)
            self._release_word(cell, t.word)

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], *, clock: str = "tick",
            max_ticks: int = 100_000) -> list:
        """Replay an arrival trace to completion across the cells
        (``clock`` as in ``ServeEngine.run``; the deterministic "tick"
        clock is the default)."""
        pending = sorted(requests, key=lambda r: r.t_arrive)
        t0 = time.monotonic()
        skipped = 0.0
        for _ in range(max_ticks):
            now = (self.ticks if clock == "tick"
                   else time.monotonic() - t0 + skipped)
            while pending and pending[0].t_arrive <= now:
                self.submit(pending.pop(0))
            if not self.has_work():
                if not pending:
                    return self.finished
                if clock == "wall":
                    skipped += pending[0].t_arrive - now
                    now = time.monotonic() - t0 + skipped
                self.submit(pending.pop(0))
            self.tick(now)
        raise RuntimeError(f"disagg loop did not converge in {max_ticks} "
                           f"ticks ({len(self.finished)} finished)")

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Handoff-path counters.  ``handoff_signals`` counts
        put-with-signal transfers and ``handoff_waits`` per-transfer
        waits on the mailbox queue; ``handoff_quiets`` counts tick-global
        barriers on it (the contract: ZERO).  With ``router="amo"`` the
        router and allocator counters ride along: ``router_quiets``
        (barriers on the router queue AND every cell's pool queue, also
        pinned to zero), ``steals``, ``alloc_cas_retries``."""
        hs = self.hq.stats()
        out = dict(self.handoff)
        out["handoff_signals"] = hs["signal_puts"]
        out["handoff_waits"] = hs["signal_waits"]
        out["handoff_quiets"] = hs["quiets"] + hs["fences"]
        out["handoff_amos"] = hs["amos"]
        if self.router_mode == "amo":
            rs = self.router.queue_stats()
            out["router_amos"] = rs["amos"]
            out["router_quiets"] = rs["quiets"] + rs["fences"]
            out["steals"] = self.router.stats["steals"]
            out["router_cas_retries"] = self.router.stats["cas_retries"]
            out["alloc_cas_retries"] = sum(p.stats["cas_retries"]
                                           for p in self.pools)
            for p in self.pools:
                ps = p.queue_stats()
                out["router_quiets"] += ps["quiets"] + ps["fences"]
        else:
            out["router_amos"] = 0
            out["router_quiets"] = 0
            out["steals"] = 0
            out["router_cas_retries"] = 0
            out["alloc_cas_retries"] = 0
        return out

    def reset_metrics(self) -> None:
        for e in self.engines:
            e.reset_metrics()
        self.ticks = 0
        for k in self.handoff:
            self.handoff[k] = 0
        reset_swap_stats(self.swap_stats)
        for k in self.hq._stats:
            self.hq._stats[k] = 0
        if self.router_mode == "amo":
            for k in self.router.q._stats:
                self.router.q._stats[k] = 0
            for k in self.router.stats:
                self.router.stats[k] = 0
            for p in self.pools:
                for k in p.q._stats:
                    p.q._stats[k] = 0
                for k in p.stats:
                    p.stats[k] = 0

    def metrics(self) -> dict:
        """The colocated engine's summary shape, aggregated over cells,
        plus the handoff counters and a per-cell breakdown."""
        done = self.finished
        lat = np.array([r.t_finish - r.t_arrive for r in done])
        ttft = np.array([r.t_first - r.t_arrive for r in done
                         if r.t_first is not None])
        dec = np.asarray([g for e in self.engines for g in e.itl])
        toks = sum(len(r.out) for r in done)
        span = max((r.t_finish for r in done), default=0.0) \
            - min((r.t_arrive for r in done), default=0.0)
        pct = (lambda a, p: float(np.percentile(a, p)) if a.size else 0.0)

        def agg(dicts):
            out: dict = {}
            for d in dicts:
                for k, v in d.items():
                    out[k] = out.get(k, 0) + v
            return out

        sp = agg(e.spec_stats for e in self.engines)
        sp["accept_rate"] = (sp["accepted"] / sp["drafted"]
                             if sp.get("drafted") else 0.0)
        sp["tokens_per_tick"] = (sp["emitted"] / sp["verify_seqs"]
                                 if sp.get("verify_seqs") else 0.0)
        shed = [r for e in self.engines for r in e.shed]
        pol = agg(e.slo.stats for e in self.engines
                  if e.slo is not None) or None
        return {
            "requests": len(done),
            "tokens_out": int(toks),
            "span_s": float(span),
            "throughput_tok_s": toks / span if span > 0 else 0.0,
            "latency_p50_s": pct(lat, 50), "latency_p99_s": pct(lat, 99),
            "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
            "decode_p50_s": pct(dec, 50), "decode_p99_s": pct(dec, 99),
            "ticks": self.ticks,
            "steps": agg(e.steps for e in self.engines),
            "sched": agg(e.sched.stats for e in self.engines),
            "kv": agg(e.kv.stats for e in self.engines),
            "spec": sp,
            "slo": slo_summary(done, shed, pol),
            "swap": dict(self.swap_stats),
            "handoff": self.stats(),
            "cells": [{"cell": c.cell, "role": c.role, "pes": list(c.pes),
                       "steps": dict(e.steps),
                       "sched": dict(e.sched.stats),
                       "kv": dict(e.kv.stats)}
                      for c, e in zip(self.cells, self.engines)],
        }
