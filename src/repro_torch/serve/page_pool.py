"""Lock-free symmetric page allocator (POSH §4.6 put to work) — the
counterpart of ``repro.serve.page_pool``.

The host-side ``PagedKVCache`` free list is a Python ``list``: correct,
but host-serial.  This pool moves the free-list STATE onto symmetric
counter words (carved ``SignalPad``-style from a
:class:`~repro_torch.core.heap.SymmetricHeap`) and makes every
transition a queue AMO (``CommQueue.amo_nbi``), so any actor claims or
returns pages by fetch-&-op arbitration.

Word layout (one ``(3 + n_pages)``-word symmetric object of int64: the
tagged head needs 64 bits):

    word 0   BUMP    count of pages ever taken from the virgin region;
                     page id = 1 + fetch_add(BUMP, 1) while < n_pages
    word 1   TOP     free-stack head, tag-encoded: ``(tag << 32) | page``
                     (page 0 = empty: the null page is never free).  The
                     tag increments on every successful CAS, the ABA
                     guard: a slow actor whose snapshot head was popped
                     and pushed back fails its CAS and retries.
    word 2   NAVAIL  frees minus allocs; ``n_free = (n_pages-1) + NAVAIL``
    word 3+p NEXT[p] stack link: the page below ``p`` (0 terminates)

From a fresh pool the stack is empty and the bump pointer grants 1, 2,
3, … — what popping ``list(range(n-1, 0, -1))`` yields; ``push_pages``
pushes in reversed order so ``pages[0]`` lands on top, as
``extend(reversed(pages))`` + ``pop()`` does.  A single-actor op
sequence is therefore the host free list's, page id for page id, which
is what lets ``PagedKVCache.attach_pool`` swap it in under the serving
stack.

The words are host control state, as in the reference (numpy there): a
CPU int64 tensor, so an AMO's fetched value is read with no device
synchronization.  Every AMO is drained by ``amo_wait`` on its own word,
never by a queue-global ``quiet`` (``queue_stats()['quiets'] == 0``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.heap import SymmetricHeap
from repro_torch.core.ordering import CommQueue, LocalTransport
from repro_torch.core.signals import SignalPad

W_BUMP = 0
W_TOP = 1
W_NAVAIL = 2
W_NEXT = 3

_TAG_SHIFT = 32
_PAGE_MASK = (1 << _TAG_SHIFT) - 1


class SymmetricPagePool:
    """CAS-arbitrated page free list on symmetric counter words.

    ``n_actors`` sizes the actor space (``LocalTransport`` ranks): every
    AMO targets the pool words on rank 0, and concurrent actors' AMOs
    linearize in the queue's seeded delivery shuffle."""

    def __init__(self, n_pages: int, *, n_actors: int = 1, delivery_seed=0,
                 name: str = "pool_words"):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.n_pages = int(n_pages)
        self._limit = int(n_pages)     # bump ceiling: growth never raises
                                       # it (grown ids enter through the
                                       # stack, or they'd be granted twice)
        self.heap = SymmetricHeap(("pool",))
        self.pad = SignalPad(self.heap, W_NEXT + self.n_pages, name=name)
        self._state = {self.pad.handle.name:
                       torch.zeros((int(n_actors), self.pad.n),
                                   dtype=torch.int64)}
        self.q = CommQueue("pool", self._state,
                           transport=LocalTransport(int(n_actors)),
                           delivery_seed=delivery_seed)
        self.stats = {"allocs": 0, "frees": 0, "cas_retries": 0,
                      "bump_allocs": 0, "stack_allocs": 0}

    # ------------------------------------------------------------------
    # AMO primitives: issue + per-word drain (never quiet)
    # ------------------------------------------------------------------
    def amo_issue(self, op: str, word: int, value=None, cond=None, *,
                  actor: int = 0):
        """Issue one pool-word AMO without draining (tests interleave
        issues before the drain linearizes them).  Returns the pending
        ``NbiValue``."""
        return self.q.amo_nbi(  # shmem: deferred-drain
            self.pad.handle, op, [(int(actor), 0)],
            value=value, cond=cond, offset=int(word))

    def amo_drain(self, word: int) -> None:
        """Drain one word: ``amo_wait``, the AMO linearization edge."""
        self.q.amo_wait(self.pad.handle, offset=int(word))

    def _amo(self, op: str, word: int, value=None, cond=None, *,
             actor: int = 0) -> int:
        v = self.amo_issue(op, word, value, cond, actor=actor)
        self.amo_drain(word)
        return int(v.value())

    # ------------------------------------------------------------------
    # pop / push: a tagged Treiber stack over a bump fallback
    # ------------------------------------------------------------------
    def pop_page(self, *, actor: int = 0) -> Optional[int]:
        """Claim one page, or None when the pool is exhausted."""
        while True:
            top = self._amo("fetch", W_TOP, actor=actor)
            page, tag = top & _PAGE_MASK, top >> _TAG_SHIFT
            if page == 0:
                # stack empty: bump the virgin region (reserve, then undo
                # on overshoot, so the counter stays conservative)
                fresh = 1 + self._amo("fadd", W_BUMP, 1, actor=actor)
                if fresh >= self._limit:
                    self._amo("fadd", W_BUMP, -1, actor=actor)
                    return None
                self._amo("fadd", W_NAVAIL, -1, actor=actor)
                self.stats["allocs"] += 1
                self.stats["bump_allocs"] += 1
                return fresh
            nxt = self._amo("fetch", W_NEXT + page, actor=actor)
            new = ((tag + 1) << _TAG_SHIFT) | nxt
            old = self._amo("cswap", W_TOP, value=new, cond=top,
                            actor=actor)
            if old == top:
                self._amo("fadd", W_NAVAIL, -1, actor=actor)
                self.stats["allocs"] += 1
                self.stats["stack_allocs"] += 1
                return page
            self.stats["cas_retries"] += 1

    def _push(self, page: int, *, actor: int = 0) -> None:
        page = int(page)
        if not 0 < page < self.n_pages:
            raise ValueError(f"page {page} outside pool [1, {self.n_pages})")
        while True:
            top = self._amo("fetch", W_TOP, actor=actor)
            # link first, THEN publish: next[page] is settled before any
            # actor can pop through it
            self._amo("swap", W_NEXT + page, top & _PAGE_MASK, actor=actor)
            new = ((top >> _TAG_SHIFT) + 1) << _TAG_SHIFT | page
            old = self._amo("cswap", W_TOP, value=new, cond=top,
                            actor=actor)
            if old == top:
                self._amo("fadd", W_NAVAIL, 1, actor=actor)
                self.stats["frees"] += 1
                return
            self.stats["cas_retries"] += 1

    def push_pages(self, pages: Sequence[int], *, actor: int = 0) -> None:
        """Return pages LIFO: ``pages[0]`` ends on top."""
        for p in reversed(list(pages)):
            self._push(p, actor=actor)

    def pop_pages(self, n: int, *, actor: int = 0) -> Optional[list[int]]:
        """All-or-nothing claim of ``n`` pages.  On shortfall the taken
        pages are pushed back in pop order, which restores the pool to
        its exact pre-call state."""
        taken: list[int] = []
        for _ in range(int(n)):
            p = self.pop_page(actor=actor)
            if p is None:
                self.push_pages(taken, actor=actor)
                return None
            taken.append(p)
        return taken

    # ------------------------------------------------------------------
    # accounting and growth
    # ------------------------------------------------------------------
    def n_free(self, *, actor: int = 0) -> int:
        """Free-page count: ``(n_pages - 1) + NAVAIL``, read atomically."""
        return (self.n_pages - 1) + self._amo("fetch", W_NAVAIL, actor=actor)

    def grow_pages(self, new_ids: Sequence[int], *, actor: int = 0) -> None:
        """Admit freshly grown page ids: the words object is realloc'd to
        cover their NEXT links, and they enter through the STACK
        (descending push, so the lowest id pops first, as the host
        ``extend(range(new_n-1, old-1, -1))``), never the bump region."""
        ids = sorted(int(p) for p in new_ids)
        if not ids:
            return
        self.n_pages += len(ids)
        new_len = W_NEXT + self.n_pages
        if new_len > self.pad.n:
            self.pad.handle = self.heap.realloc(self.pad.handle, (new_len,))
            self.pad.n = new_len
            # every AMO drains at issue, so the queue is idle here and its
            # settled state can be widened in place
            arr = self.q._state[self.pad.handle.name]
            self.q._state[self.pad.handle.name] = torch.cat(
                [arr, arr.new_zeros((arr.shape[0], new_len - arr.shape[1]))],
                dim=1)
        for p in reversed(ids):
            if not 0 < p:
                raise ValueError(f"page {p} outside pool")
            self._push(p, actor=actor)
        # the pushes bumped NAVAIL, but growth already widened the n_free
        # base (n_pages - 1): cancel them, or the count inflates
        self._amo("fadd", W_NAVAIL, -len(ids), actor=actor)
        self.stats["frees"] -= len(ids)   # growth is not a free

    def queue_stats(self) -> dict:
        """The pool queue's counters (``quiets == 0`` is pinned)."""
        return self.q.stats()
