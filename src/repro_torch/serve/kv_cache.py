"""Paged KV cache on the symmetric heap.

The counterpart of ``repro.serve.kv_cache.PagedKVCache``.  The page
pool is ONE symmetric allocation: a ``(n_pages, 2, n_layers,
page_tokens, kv_heads, head_dim)`` tensor carved from
``SymmetricHeap``, so a *block table* — a plain array of page ids — is
valid on every PE (Fact 1: the page id is the remote address).  At
tensor-parallel size > 1, ``kv_heads`` is each PE's share and the
serving exec stacks one such pool per PE (``engine.StackedExec``),
each with its own null page.

Page 0 is the *null page*: block tables are padded with it, and writes
for masked-out batch slots land there.  Real allocations hand out ids
1..n_pages-1 from a LIFO free list (freshly freed pages are reused
while still warm in cache); ``attach_pool`` swaps the host list for a
lock-free ``serve.page_pool.SymmetricPagePool`` with the same grant
order.  The bookkeeping is host-side Python; the pool tensor lives on
the serving device and the engine writes it in place.

The prefix index publishes a finished prompt's full pages as migratable
(pinned out of the free list, at most a quarter of the pool), and a
later request with the same prefix resumes from them: one ``put_nbi``
of one pool row per page on a ``CommQueue``, drained by ONE ``quiet()``
per tick (``issue_migrations``; §3.2's point).

A disaggregated handoff (``serve.disagg``) moves a sequence between two
caches: ``export_seq`` detaches the producer's table with its pages
still resident (the payload source), ``adopt_seq`` carves the
consumer's landing pages (the block-table remap), and
``release_pages`` returns the producer's pages once the consumer
acknowledges.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.heap import SymHandle, SymmetricHeap

NULL_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PageMigration:
    """One planned page move: pool row ``src_page`` on PE ``src_pe`` ->
    pool row ``dst_page`` on PE ``dst_pe``."""

    src_pe: int
    dst_pe: int
    src_page: int
    dst_page: int


class PagedKVCache:
    """Fixed-size KV pages carved from the symmetric heap."""

    def __init__(self, heap: SymmetricHeap, *, n_layers: int,
                 kv_heads: int, head_dim: int, n_pages: int,
                 page_tokens: int, dtype=torch.float32,
                 name: str = "kv_pages"):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        self.heap = heap
        self.page_tokens = int(page_tokens)
        self.n_layers = int(n_layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.handle: SymHandle = heap.alloc(
            name, (n_pages, 2, n_layers, page_tokens, kv_heads, head_dim),
            dtype)
        self.dtype = self.handle.dtype
        # LIFO free list over real pages (1..n-1); page 0 stays null.
        # ``attach_pool`` swaps this host list for a SymmetricPagePool
        # with the same grant order
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._pool = None                 # SymmetricPagePool when attached
        self.tables: dict = {}            # seq id -> list[int] page ids
        # prefix index: tuple(prompt tokens of k full pages) ->
        # (owner_pe, [page ids on the owner]), the migration source.
        # Registered pages are PINNED (out of circulation); pinning is
        # capped at a quarter of the pool so it cannot starve admissions
        self._prefix: dict = {}
        self.pin_budget = max((n_pages - 1) // 4, 2)
        self.pinned_pages = 0
        self.stats = {"page_allocs": 0, "page_frees": 0, "migrations": 0,
                      "prefix_hits": 0, "rewound_pages": 0,
                      "exported_pages": 0, "adopted_pages": 0}

    # ------------------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.handle.shape[0]

    def n_free(self) -> int:
        return self._pool.n_free() if self._pool is not None \
            else len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_tokens)

    # ------------------------------------------------------------------
    # free-list backend: the host list, or an attached SymmetricPagePool
    # ------------------------------------------------------------------
    def attach_pool(self, pool) -> None:
        """Swap the host free list for a lock-free
        ``serve.page_pool.SymmetricPagePool``.  Legal only on a pristine
        cache (no tables, full free list): the two backends grant the
        same page ids only from the same starting point."""
        if self.tables or len(self._free) != self.n_pages - 1:
            raise ValueError(
                "attach_pool needs a pristine cache (no live tables, "
                "full free list)")
        if pool.n_pages != self.n_pages:
            raise ValueError(
                f"pool covers {pool.n_pages} pages, cache has "
                f"{self.n_pages}")
        self._pool = pool
        self._free = []

    def _pop_page(self) -> Optional[int]:
        if self._pool is not None:
            return self._pool.pop_page()
        return self._free.pop() if self._free else None

    def _pop_pages(self, n: int) -> Optional[list[int]]:
        """All-or-nothing claim; the free list is untouched on shortfall."""
        if self._pool is not None:
            return self._pool.pop_pages(n)
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def _push_pages(self, pages: Sequence[int]) -> None:
        """LIFO return: ``pages[0]`` ends on top on either backend."""
        if self._pool is not None:
            self._pool.push_pages(list(pages))
        else:
            self._free.extend(reversed(list(pages)))

    # ------------------------------------------------------------------
    # allocation — host side
    # ------------------------------------------------------------------
    def alloc_seq(self, seq_id, n_tokens: int) -> bool:
        """Reserve pages covering ``n_tokens`` for a new sequence.
        All-or-nothing; False when the pool cannot cover it."""
        need = max(self.pages_for(n_tokens), 1)
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id!r} already has pages")
        pages = self._pop_pages(need)
        if pages is None:
            return False
        self.tables[seq_id] = pages
        self.stats["page_allocs"] += need
        return True

    def ensure(self, seq_id, n_tokens: int) -> bool:
        """Grow a live sequence's table to cover ``n_tokens``.  False
        when out of pages — the scheduler then preempts someone."""
        table = self.tables[seq_id]
        while len(table) * self.page_tokens < n_tokens:
            page = self._pop_page()
            if page is None:
                return False
            table.append(page)
            self.stats["page_allocs"] += 1
        return True

    def truncate(self, seq_id, n_tokens: int) -> int:
        """Shrink a live sequence's table to the pages covering its
        first ``n_tokens`` tokens (page-granular rewind).  Freed pages go
        back LIFO; slots past ``n_tokens`` in the kept final page are
        dead by length bookkeeping.  Returns the pages freed."""
        table = self.tables[seq_id]
        keep = self.pages_for(n_tokens)
        freed = table[keep:]
        if freed:
            del table[keep:]
            self._push_pages(freed)
            self.stats["page_frees"] += len(freed)
            self.stats["rewound_pages"] += len(freed)
        return len(freed)

    def free_seq(self, seq_id) -> None:
        pages = self.tables.pop(seq_id)
        self.stats["page_frees"] += len(pages)
        # LIFO: pages[0] ends on top of the free list
        self._push_pages(pages)

    def attach_seq(self, seq_id, pages: Sequence[int]) -> None:
        """Adopt already-filled pages (migrated prefix pages) as the head
        of a new sequence's block table."""
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id!r} already has pages")
        self.tables[seq_id] = list(pages)

    def take_pages(self, n: int) -> Optional[list[int]]:
        """Pop ``n`` pages ownerless (a migration's landing zone);
        all-or-nothing."""
        pages = self._pop_pages(n)
        if pages is None:
            return None
        self.stats["page_allocs"] += n
        return pages

    # ------------------------------------------------------------------
    # cross-cache handoff (disaggregated prefill/decode cells)
    # ------------------------------------------------------------------
    def export_seq(self, seq_id) -> list[int]:
        """Detach a sequence's table for a handoff: the pages leave the
        table but NOT the pool — they stay resident as the
        put-with-signal payload source until the consumer acknowledges
        (then ``release_pages``).  Returns the page ids in table order."""
        pages = self.tables.pop(seq_id)
        self.stats["exported_pages"] += len(pages)
        return pages

    def adopt_seq(self, seq_id, n: int) -> Optional[list[int]]:
        """The consumer half of a handoff: carve ``n`` landing pages from
        this pool and attach them as ``seq_id``'s table.  The landing ids
        are this pool's own (the block-table remap; page rows are
        position-independent).  All-or-nothing: None when the pool
        cannot cover the sequence."""
        pages = self.take_pages(n)
        if pages is None:
            return None
        self.attach_seq(seq_id, pages)
        self.stats["adopted_pages"] += n
        return pages

    def release_pages(self, pages: Sequence[int]) -> None:
        """Return exported pages once the consumer has acknowledged."""
        self.stats["page_frees"] += len(pages)
        self._push_pages(list(pages))

    # ------------------------------------------------------------------
    def block_table(self, seq_ids, n_slots: int) -> np.ndarray:
        """(B, n_slots) int32, padded with the null page.  ``None``
        entries in ``seq_ids`` (empty batch slots) become all-null."""
        out = np.full((len(seq_ids), n_slots), NULL_PAGE, np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            pages = self.tables[sid]
            if len(pages) > n_slots:
                raise ValueError(
                    f"sequence {sid!r} has {len(pages)} pages > "
                    f"{n_slots} table slots")
            out[i, :len(pages)] = pages
        return out

    # ------------------------------------------------------------------
    # prefix cache (the migration source)
    # ------------------------------------------------------------------
    def register_prefix(self, tokens, owner_pe: int,
                        pages: Sequence[int]) -> bool:
        """Publish ``len(pages)`` FULL pages holding the K/V of
        ``tokens[:len(pages) * page_tokens]`` as migratable from
        ``owner_pe`` (block-table offsets are symmetric, Fact 1).  False
        (the caller keeps the pages) when the prefix is already
        published or pinning would pass the pin budget."""
        k = len(pages)
        key = tuple(int(t) for t in tokens[:k * self.page_tokens])
        if not key or key in self._prefix \
                or self.pinned_pages + k > self.pin_budget:
            return False
        self._prefix[key] = (int(owner_pe), list(pages))
        self.pinned_pages += k
        return True

    def lookup_prefix(self, tokens):
        """Longest registered full-page prefix of ``tokens``: (owner_pe,
        pages) or None.  ``prefix_hits`` counts resumes, not lookups (the
        scheduler records a hit when the admission succeeds)."""
        for k in range(len(tokens) // self.page_tokens, 0, -1):
            hit = self._prefix.get(
                tuple(int(t) for t in tokens[:k * self.page_tokens]))
            if hit is not None:
                return hit
        return None

    def issue_migrations(self, queue, pool: torch.Tensor,
                         migrations: Sequence[PageMigration], *,
                         pairs_of=None):
        """Issue every planned page move as a nonblocking one-sided put
        and drain with ONE ``quiet()``: however many pages move, the
        tick pays one completion barrier.  ``pool`` is the stacked
        ``(n_pe, n_pages, ...)`` state the payload rows are sliced from;
        returns the drained heap state.  ``pairs_of`` maps a migration to
        its (src, dst) PE pairs — a tensor-parallel cell moves each TP
        rank's page shard to its counterpart — and then each pair is its
        own put carrying its source PE's row alone."""
        for m in migrations:
            rows = slice(m.src_page, m.src_page + 1)
            if pairs_of is None:
                queue.put_nbi(self.handle, pool[:, rows],
                              [(m.src_pe, m.dst_pe)], offset=m.dst_page)
                continue
            for s, d in pairs_of(m):
                queue.put_nbi(self.handle, pool[s:s + 1, rows], [(s, d)],
                              offset=m.dst_page)
        self.stats["migrations"] += len(migrations)
        return queue.quiet()

    def zeros(self, device=None) -> torch.Tensor:
        return torch.zeros(self.handle.shape, dtype=self.dtype,
                           device=device)

    def grow(self, extra_pages: int,
             pool: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Extend the pool by ``extra_pages`` through ``heap.realloc`` (in
        place when the heap has room next door, moved otherwise; the
        offset stays symmetric).  The new ids join the free list lowest
        first.  Returns the grown pool tensor, ``pool``'s pages carried
        over (zeros on the CPU when no pool is given)."""
        old_n = self.handle.shape[0]
        new_n = old_n + int(extra_pages)
        self.handle = self.heap.realloc(self.handle,
                                        (new_n,) + self.handle.shape[1:])
        if self._pool is not None:
            self._pool.grow_pages(range(old_n, new_n))
        else:
            self._free.extend(range(new_n - 1, old_n - 1, -1))
        if pool is None:
            return self.zeros()
        out = pool.new_zeros((new_n,) + tuple(pool.shape[1:]))
        out[:old_n] = pool
        return out
