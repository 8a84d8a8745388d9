"""Paged KV cache on the symmetric heap.

The counterpart of ``repro.serve.kv_cache.PagedKVCache`` for colocated
serving.  The page pool is ONE symmetric allocation: a ``(n_pages, 2,
n_layers, page_tokens, kv_heads, head_dim)`` tensor carved from
``SymmetricHeap``, so a *block table* — a plain array of page ids — is
valid on every PE (Fact 1: the page id is the remote address).

Page 0 is the *null page*: block tables are padded with it, and writes
for masked-out batch slots land there.  Real allocations hand out ids
1..n_pages-1 from a LIFO free list (freshly freed pages are reused
while still warm in cache).  The bookkeeping is host-side Python; the
pool tensor lives on the serving device and the engine writes it in
place.

Prefix-cache pinning and cross-PE page migration (``issue_migrations``)
need the ``CommQueue`` port and arrive with the slice that brings it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.heap import SymHandle, SymmetricHeap

NULL_PAGE = 0


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
        # LIFO free list over real pages (1..n-1); page 0 stays null
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self.tables: dict = {}            # seq id -> list[int] page ids
        self.stats = {"page_allocs": 0, "page_frees": 0, "rewound_pages": 0}

    # ------------------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.handle.shape[0]

    def n_free(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_tokens)

    # ------------------------------------------------------------------
    # allocation — host side
    # ------------------------------------------------------------------
    def alloc_seq(self, seq_id, n_tokens: int) -> bool:
        """Reserve pages covering ``n_tokens`` for a new sequence.
        All-or-nothing; False when the pool cannot cover it."""
        need = max(self.pages_for(n_tokens), 1)
        if seq_id in self.tables:
            raise ValueError(f"sequence {seq_id!r} already has pages")
        if need > len(self._free):
            return False
        self.tables[seq_id] = [self._free.pop() for _ in range(need)]
        self.stats["page_allocs"] += need
        return True

    def ensure(self, seq_id, n_tokens: int) -> bool:
        """Grow a live sequence's table to cover ``n_tokens``.  False
        when out of pages — the scheduler then preempts someone."""
        table = self.tables[seq_id]
        while len(table) * self.page_tokens < n_tokens:
            if not self._free:
                return False
            table.append(self._free.pop())
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
            self._free.extend(reversed(freed))
            self.stats["page_frees"] += len(freed)
            self.stats["rewound_pages"] += len(freed)
        return len(freed)

    def free_seq(self, seq_id) -> None:
        pages = self.tables.pop(seq_id)
        self.stats["page_frees"] += len(pages)
        # LIFO: pages[0] ends on top of the free list
        self._free.extend(reversed(pages))

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

    def zeros(self, device=None) -> torch.Tensor:
        return torch.zeros(self.handle.shape, dtype=self.dtype,
                           device=device)
