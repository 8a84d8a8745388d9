"""repro_torch.serve.page_pool: the lock-free page allocator, case for
case with ``tests/test_page_pool.py`` (the 8-PE mesh suite aside), and
held to the JAX package's pool word for word.

  * the host-LIFO oracle: random alloc/free/rollback/grow traces give
    the host list's grants exactly, for every delivery seed;
  * seeded multi-actor interleavings and issue-level concurrent bump
    reservations: no double grant, no leak, page conservation;
  * the ABA interleaving the tag guard exists for, a CAS defeat that
    must retry, the empty-pool and all-or-nothing rollback boundaries,
    growth order and validation, and ``attach_pool`` invisibility;
  * the same op sequences (single actor, and several actors with their
    AMOs in flight together under a delivery seed) through the JAX pool
    and the port's: the same fetched values, and every word equal after
    every op.

Every test also pins the completion discipline: the pool queue drains
AMOs per word only, ``quiets == fences == 0``.
"""
import random

import numpy as np
import pytest
import torch

from repro.serve.page_pool import SymmetricPagePool as JPool
from repro_torch.serve.page_pool import (W_BUMP, W_NAVAIL, W_NEXT, W_TOP,
                                         _PAGE_MASK, _TAG_SHIFT,
                                         SymmetricPagePool)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


class HostList:
    """The host free list the pool must equal: pages ``1..n-1`` popped
    from the tail, frees ``extend(reversed(...))``."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, 0, -1))

    def pop_page(self):
        return self.free.pop() if self.free else None

    def pop_pages(self, n):
        if n > len(self.free):
            return None
        return [self.free.pop() for _ in range(n)]

    def push_pages(self, pages):
        self.free.extend(reversed(list(pages)))

    def n_free(self):
        return len(self.free)

    def grow_pages(self, new_ids):
        ids = sorted(new_ids)
        self.n_pages += len(ids)
        self.free.extend(reversed(ids))


def _zero_quiet(pool):
    qs = pool.queue_stats()
    assert qs["quiets"] == 0 and qs["fences"] == 0, qs
    assert qs["amos"] > 0 and qs["amo_waits"] > 0


def test_exported_layout_constants_match_reference():
    from repro.serve import page_pool as jpp
    assert (W_BUMP, W_TOP, W_NAVAIL, W_NEXT, _TAG_SHIFT, _PAGE_MASK) == (
        jpp.W_BUMP, jpp.W_TOP, jpp.W_NAVAIL, jpp.W_NEXT, jpp._TAG_SHIFT,
        jpp._PAGE_MASK)
    pool = SymmetricPagePool(6)
    words = pool.q.state[pool.pad.handle.name]
    assert words.dtype == torch.int64 and words.device.type == "cpu"
    assert tuple(words.shape) == (1, W_NEXT + 6)


# ======================================================================
# property: single-actor traces equal the host list
# ======================================================================
def run_trace(rng: random.Random, delivery_seed: int):
    n = rng.randint(4, 12)
    pool = SymmetricPagePool(n, delivery_seed=delivery_seed)
    host = HostList(n)
    held = []
    for _ in range(rng.randint(5, 40)):
        op = rng.choices(["pop", "popn", "push", "grow"],
                         weights=[5, 2, 4, 1])[0]
        if op == "pop":
            gp, gh = pool.pop_page(), host.pop_page()
            assert gp == gh, (gp, gh)
            if gp is not None:
                held.append(gp)
        elif op == "popn":
            k = rng.randint(1, 4)
            gp, gh = pool.pop_pages(k), host.pop_pages(k)
            assert gp == gh, (gp, gh)       # incl. None == None rollback
            if gp is not None:
                held.extend(gp)
        elif op == "push" and held:
            k = rng.randint(1, len(held))
            idx = rng.sample(range(len(held)), k)
            back = [held[i] for i in idx]
            pool.push_pages(back)
            host.push_pages(back)
            held = [p for i, p in enumerate(held) if i not in idx]
        elif op == "grow":
            k = rng.randint(1, 3)
            ids = range(pool.n_pages, pool.n_pages + k)
            pool.grow_pages(ids)
            host.grow_pages(ids)
        assert pool.n_free() == host.n_free()
    rest = []
    while True:
        gp, gh = pool.pop_page(), host.pop_page()
        assert gp == gh
        if gp is None:
            break
        rest.append(gp)
    assert sorted(held + rest) == list(range(1, pool.n_pages))
    assert pool.n_free() == 0
    _zero_quiet(pool)


if HAVE_HYPOTHESIS:
    @settings(max_examples=150, deadline=None)
    @given(st.integers(0, 2 ** 32 - 1), st.integers(0, 35))
    def test_pool_matches_host_lifo_property(seed, dseed):
        run_trace(random.Random(seed), dseed)
else:
    @pytest.mark.parametrize("chunk", range(10))
    def test_pool_matches_host_lifo_property(chunk):
        # 10 chunks x 15 traces, delivery seed swept 0..35 with them
        for i in range(15):
            k = chunk * 15 + i
            run_trace(random.Random(k), k % 36)


# ======================================================================
# multi-actor interleavings: allocator invariants under the shuffle
# ======================================================================
N_ACTORS = 4


def run_concurrent_trace(rng: random.Random, delivery_seed: int):
    n = rng.randint(6, 16)
    pool = SymmetricPagePool(n, n_actors=N_ACTORS,
                             delivery_seed=delivery_seed)
    held = {a: [] for a in range(N_ACTORS)}
    for _ in range(rng.randint(10, 60)):
        a = rng.randrange(N_ACTORS)
        if rng.random() < 0.6:
            p = pool.pop_page(actor=a)
            if p is not None:
                held[a].append(p)
        elif held[a]:
            k = rng.randint(1, len(held[a]))
            back, held[a] = held[a][:k], held[a][k:]
            pool.push_pages(back, actor=a)
        out = [p for ps in held.values() for p in ps]
        assert len(out) == len(set(out)), out
        assert pool.n_free() == (n - 1) - len(out)
    for a, ps in held.items():
        pool.push_pages(ps, actor=a)
    assert pool.n_free() == n - 1
    got = sorted(iter(lambda: pool.pop_page(actor=rng.randrange(N_ACTORS)),
                      None))
    assert got == list(range(1, n))
    _zero_quiet(pool)


if HAVE_HYPOTHESIS:
    @settings(max_examples=120, deadline=None)
    @given(st.integers(0, 2 ** 32 - 1), st.integers(0, 35))
    def test_pool_concurrent_invariants_property(seed, dseed):
        run_concurrent_trace(random.Random(seed), dseed)
else:
    @pytest.mark.parametrize("chunk", range(8))
    def test_pool_concurrent_invariants_property(chunk):
        for i in range(15):
            k = chunk * 15 + i
            run_concurrent_trace(random.Random(5000 + k), k % 36)


def test_concurrent_bump_reservations_grant_unique_pages():
    """Every actor's bump fetch-add is in flight before any drains; one
    ``amo_wait`` linearizes them all and each actor still gets a distinct
    fresh page, for 34 shuffle seeds and issue order."""
    for dseed in list(range(34)) + [None]:
        pool = SymmetricPagePool(2 * N_ACTORS + 1, n_actors=N_ACTORS,
                                 delivery_seed=dseed)
        pend = [pool.amo_issue("fadd", W_BUMP, 1, actor=a)
                for a in range(N_ACTORS)]
        assert not any(r.ready for r in pend)
        pool.amo_drain(W_BUMP)
        ks = [int(r.value()) for r in pend]
        assert sorted(ks) == list(range(N_ACTORS)), (dseed, ks)
        assert len({1 + k for k in ks}) == N_ACTORS
        _zero_quiet(pool)


# ======================================================================
# directed: the classic failure modes, built by hand
# ======================================================================
def test_aba_tag_guard_fails_the_stale_cas():
    """Actor 1 snapshots TOP (page a) and NEXT[a]; actor 0 pops a and b
    and pushes a back (same page on top, new tag).  Actor 1's stale
    cswap must fail."""
    pool = SymmetricPagePool(8, n_actors=2)
    a = pool.pop_page(actor=0)
    b = pool.pop_page(actor=0)
    pool.push_pages([a, b], actor=0)       # stack: a -> b
    top = pool._amo("fetch", W_TOP, actor=1)
    page, tag = top & _PAGE_MASK, top >> _TAG_SHIFT
    assert page == a
    nxt = pool._amo("fetch", W_NEXT + page, actor=1)
    assert nxt == b
    assert pool.pop_page(actor=0) == a
    assert pool.pop_page(actor=0) == b
    pool.push_pages([a], actor=0)
    top2 = pool._amo("fetch", W_TOP, actor=1)
    assert top2 & _PAGE_MASK == a          # same page value ...
    assert top2 != top                     # ... a different word
    old = pool._amo("cswap", W_TOP, value=((tag + 1) << _TAG_SHIFT) | nxt,
                    cond=top, actor=1)
    assert old != top                      # the stale CAS failed
    assert pool.pop_page(actor=1) == a
    assert pool.n_free() == pool.n_pages - 1 - 2
    _zero_quiet(pool)


def test_pop_page_retries_after_cas_defeat():
    """A competing pop lands between ``pop_page``'s TOP snapshot and its
    claim CAS: the loser retries (counted) onto the next page."""
    pool = SymmetricPagePool(8, n_actors=2)
    p1, p2 = pool.pop_page(actor=0), pool.pop_page(actor=0)
    pool.push_pages([p1, p2], actor=0)     # stack: p1 -> p2
    stolen = []
    orig = pool._amo

    def interfere(op, word, value=None, cond=None, *, actor=0):
        if (op == "fetch" and word == W_TOP and actor == 1
                and not stolen):
            out = orig(op, word, value, cond, actor=actor)
            pool._amo = orig               # interfere exactly once
            stolen.append(pool.pop_page(actor=0))
            return out
        return orig(op, word, value, cond, actor=actor)

    pool._amo = interfere
    got = pool.pop_page(actor=1)
    assert stolen == [p1]
    assert got == p2
    assert pool.stats["cas_retries"] >= 1
    assert pool.n_free() == pool.n_pages - 1 - 2
    _zero_quiet(pool)


def test_empty_pool_and_rollback_boundaries():
    pool = SymmetricPagePool(4)
    host = HostList(4)
    got = [pool.pop_page() for _ in range(3)]
    assert got == [host.pop_page() for _ in range(3)] == [1, 2, 3]
    assert pool.pop_page() is None and pool.n_free() == 0
    assert pool.pop_pages(1) is None
    pool.push_pages(got[:2])
    host.push_pages(got[:2])
    assert pool.pop_pages(3) is None and pool.n_free() == 2
    assert pool.pop_pages(2) == host.pop_pages(2)
    assert pool.pop_page() is None
    assert pool._amo("fetch", W_BUMP) == 3   # stayed conservative
    _zero_quiet(pool)


def test_grow_matches_host_growth_order():
    pool = SymmetricPagePool(3)
    host = HostList(3)
    assert pool.pop_pages(2) == host.pop_pages(2) == [1, 2]
    pool.grow_pages(range(3, 6))
    host.grow_pages(range(3, 6))
    assert pool.n_free() == host.n_free() == 3
    got = [pool.pop_page() for _ in range(4)]
    assert got == [host.pop_page() for _ in range(4)] == [3, 4, 5, None]
    _zero_quiet(pool)


def test_constructor_and_push_validation():
    with pytest.raises(ValueError, match=">= 2 pages"):
        SymmetricPagePool(1)
    pool = SymmetricPagePool(4)
    with pytest.raises(ValueError, match="outside pool"):
        pool.push_pages([0])               # the null page is never free
    with pytest.raises(ValueError, match="outside pool"):
        pool.push_pages([4])
    p = pool.pop_page()
    pool.push_pages([p])
    assert pool.n_free() == 3


def test_attach_pool_is_invisible_to_the_kv_cache():
    """A PagedKVCache driven through an attached pool grants the host
    list's pages (tables, rollbacks, growth included), and so does the
    JAX cache with its pool."""
    from repro.core.heap import SymmetricHeap as JHeap
    from repro.serve.kv_cache import PagedKVCache as JKV
    from repro_torch.core.heap import SymmetricHeap
    from repro_torch.serve.kv_cache import PagedKVCache

    def make(attach, jax_side=False):
        kv = (JKV(JHeap(("data",)), n_layers=1, kv_heads=1, head_dim=4,
                  n_pages=8, page_tokens=4) if jax_side else
              PagedKVCache(SymmetricHeap(("data",)), n_layers=1, kv_heads=1,
                           head_dim=4, n_pages=8, page_tokens=4))
        if attach:
            kv.attach_pool((JPool if jax_side else SymmetricPagePool)(
                kv.n_pages, name="pool_words_t"))
        return kv

    kvs = [make(False), make(True), make(True, jax_side=True)]
    for step in (lambda kv: kv.alloc_seq("a", 6),
                 lambda kv: kv.alloc_seq("b", 9),
                 lambda kv: kv.ensure("a", 12),
                 lambda kv: kv.free_seq("b"),
                 lambda kv: kv.take_pages(2),
                 lambda kv: kv.alloc_seq("c", 30),   # must fail all
                 lambda kv: kv.truncate("a", 4),
                 lambda kv: kv.n_free()):
        got = [step(kv) for kv in kvs]
        assert got[0] == got[1] == got[2], got
    assert kvs[0].tables == kvs[1].tables == kvs[2].tables
    _zero_quiet(kvs[1]._pool)
    with pytest.raises(ValueError, match="pristine"):
        kvs[0].attach_pool(SymmetricPagePool(8))
    fresh = make(False)
    with pytest.raises(ValueError, match="covers"):
        fresh.attach_pool(SymmetricPagePool(9))


def test_grow_through_the_kv_cache_carries_pages_over():
    """``PagedKVCache.grow`` on either backend: the same new grants as
    the JAX cache, the pool's pages carried into the grown tensor."""
    from repro.core.heap import SymmetricHeap as JHeap
    from repro.serve.kv_cache import PagedKVCache as JKV
    from repro_torch.core.heap import SymmetricHeap
    from repro_torch.serve.kv_cache import PagedKVCache

    geo = dict(n_layers=1, kv_heads=1, head_dim=4, n_pages=4, page_tokens=2)
    for attach in (False, True):
        kv = PagedKVCache(SymmetricHeap(("data",)), **geo)
        jkv = JKV(JHeap(("data",)), **geo)
        if attach:
            kv.attach_pool(SymmetricPagePool(4))
            jkv.attach_pool(JPool(4))
        assert kv.alloc_seq("a", 6) == jkv.alloc_seq("a", 6)
        pool = torch.arange(kv.zeros().numel(),
                            dtype=torch.float32).view(kv.handle.shape)
        grown = kv.grow(3, pool)
        jkv.grow(3)
        assert kv.handle.shape == jkv.handle.shape
        assert kv.handle.offset == jkv.handle.offset
        assert torch.equal(grown[:4], pool) and not grown[4:].any()
        assert kv.alloc_seq("b", 5) == jkv.alloc_seq("b", 5)
        assert kv.tables == jkv.tables and kv.n_free() == jkv.n_free()


# ======================================================================
# the port's pool against the JAX pool, word for word
# ======================================================================
def _words(pool):
    w = pool.q.state[pool.pad.handle.name]
    return np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w)


def _jax_pool_trace(seed, delivery_seed, n_actors):
    """The same random op sequence through both pools: pops, all-or-
    nothing claims, pushes, growth and, with several actors, batches of
    AMOs in flight together before one drain — the fetched values and
    every word must be equal after every op."""
    rng = random.Random(seed)
    n = rng.randint(5, 12)
    ours = SymmetricPagePool(n, n_actors=n_actors,
                             delivery_seed=delivery_seed)
    ref = JPool(n, n_actors=n_actors, delivery_seed=delivery_seed)
    held = []
    for _ in range(rng.randint(10, 40)):
        op = rng.choices(["pop", "popn", "push", "grow", "inflight"],
                         weights=[5, 2, 4, 1, 2 if n_actors > 1 else 0])[0]
        a = rng.randrange(n_actors)
        got = (None, None)
        if op == "pop":
            got = (ours.pop_page(actor=a), ref.pop_page(actor=a))
            if got[1] is not None:
                held.append(got[1])
        elif op == "popn":
            k = rng.randint(1, 4)
            got = (ours.pop_pages(k, actor=a), ref.pop_pages(k, actor=a))
            held.extend(got[1] or [])
        elif op == "push" and held:
            k = rng.randint(1, len(held))
            back, held = held[:k], held[k:]
            got = (ours.push_pages(back, actor=a),
                   ref.push_pages(back, actor=a))
        elif op == "grow":
            ids = range(ours.n_pages, ours.n_pages + rng.randint(1, 2))
            got = (ours.grow_pages(ids), ref.grow_pages(ids))
        else:
            # fetch-adds on one word from every actor, all in flight
            word = rng.choice([W_BUMP, W_NAVAIL])
            vals = [rng.randint(-2, 2) or 1 for _ in range(n_actors)]
            pend = [(ours.amo_issue("fadd", word, v, actor=i),
                     ref.amo_issue("fadd", word, v, actor=i))
                    for i, v in enumerate(vals)]
            ours.amo_drain(word)
            ref.amo_drain(word)
            got = ([int(p.value()) for p, _ in pend],
                   [int(r.value()) for _, r in pend])
            # undo, so the pool stays a pool
            for i, v in enumerate(vals):
                ours._amo("fadd", word, -v, actor=i)
                ref._amo("fadd", word, -v, actor=i)
        assert got[0] == got[1], (op, got)
        np.testing.assert_array_equal(_words(ours), _words(ref))
        assert ours.n_free(actor=a) == ref.n_free(actor=a)
        assert ours.stats == ref.stats
    assert ours.queue_stats()["amos"] == ref.queue_stats()["amos"]
    _zero_quiet(ours)


@pytest.mark.parametrize("n_actors", [1, 3])
@pytest.mark.parametrize("chunk", range(3))
def test_pool_words_equal_jax_pool_after_every_op(chunk, n_actors):
    for i in range(8):
        k = 100 * n_actors + chunk * 8 + i
        _jax_pool_trace(k, [None, 0, 7, 31][k % 4], n_actors)
