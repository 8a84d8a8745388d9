"""Dynamic happens-before checking for the §3.2 completion model (the
port's copy of ``repro.analysis.shmemcheck``: the same rules, findings
and API, hooked into ``repro_torch.core``).

The paper proves exactly which delivery orders a correct program may
rely on: nothing between ordering points, per-destination order across
a ``fence``, everything complete at ``quiet``.  The ``CommQueue``
deliberately stresses that freedom (the seeded delivery shuffle), so a
program whose result depends on an *unordered* pair of conflicting
accesses is silently nondeterministic — the exact defect class a
ThreadSanitizer-style happens-before checker catches in shared-memory
code.  This module is that checker for the shmem substrate:

  * every ``put_nbi`` records a write interval (dst PE, symmetric
    object, row range) into the issuing queue's *pending set*;
  * ``fence(dst)`` / ``quiet()`` insert the happens-before edge the
    paper grants: pending intervals covered by the drain are retired —
    later accesses are ordered after them;
  * two overlapping pending writes to the same (dst, object) with no
    drain between them is a **write/write race** (the shuffle decides
    who wins);
  * reading the queue's heap state while a put targeting it is still
    pending is a **write/read race** (the model leaves the target range
    undefined until delivery);
  * the symmetric-heap hooks track object lifetime: a queue op through
    a handle whose extent was freed (or moved by ``realloc``) is a
    **use-after-free / stale handle**, a second ``free`` of a retired
    extent is a **double-free**, and ``compare_heaps`` checks the
    paper's Fact 1 — identically-driven heaps must produce identical
    (name, offset) sequences — reporting the first divergent
    allocation (**offset asymmetry**);
  * a drain re-entered from a drain callback (``fence``/``quiet``
    called while the same queue is draining) is flagged — the
    deadlock analogue of a blocking collective inside completion
    handling;
  * put-with-signal (``core.signals``) adds the per-transfer edge:
    ``signal_wait_until`` retires EXACTLY the pending intervals of
    puts guarding that signal word; reading the payload object while
    its guard is still pending is a **signal-race** (the wait, not the
    issue, is the completion point); and writing a registered signal
    word with a plain ``put_nbi`` is a **raw-signal** (the word's
    payload-before-signal guarantee only holds for signal updates);
  * queue AMOs (``CommQueue.amo_nbi``) add the linearization edge: an
    AMO is its own linearization point, so two pending AMOs on one
    word are NEVER a race (the drain order linearizes them) and
    ``amo_wait`` retires exactly the word's pending AMOs — but a plain
    ``put_nbi`` overlapping a registered ATOMIC word (or an AMO on a
    word with a plain put pending) is an **amo-race**: the shuffle
    decides whether the blind write lands before or after the
    read-modify-write, so the fetched value is undefined;
  * ``signal_reset`` (the queue-visible word-recycling path) is only
    legal on a retired word — resetting while guarded transfers are
    still pending is flagged as a **signal-race**.

Findings are *reports*, not exceptions: each carries the rule, a
message, and the source locations of both conflicting events, so a CI
run can batch and upload them (the pytest plugin
``repro_torch.analysis.pytest_arm`` fails the owning test and writes
``shmemcheck-report.json``).

Zero-cost-when-off: ``repro_torch.core.ordering`` and
``repro_torch.core.heap`` each hold a module-global ``_checker = None``
hook; ``enable()`` installs one checker into both.  Disabled, an instrumented call site
costs one global load and an is-None test — the trace-time analogue of
compiling POSH without ``_SAFE`` (§4.7).  The checker watches the
queue's bookkeeping (handles, offsets, row counts, drains), never the
payloads' values, so it works alike on CPU and CUDA tensors.  Unlike the
reference's, the port's queues and heaps do not arm themselves from
``REPRO_SHMEMCHECK``: ``enable()`` (or the pytest plugin) does.

NOTE on gets: this queue satisfies ``get_nbi`` against the *settled*
state at ``quiet`` (the conservative reading the CommQueue documents),
so a get overlapping a pending put is deterministic here and is NOT
flagged; reading the ``NbiValue`` early already raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import operator
import os
import sys
from collections import Counter
from typing import Optional

MAX_FINDINGS = 1000   # memory bound for long racy replays (the multipe
                      # ordering sweeps deliberately race thousands of
                      # times); `dropped` counts the overflow

_SRC_SKIP = (os.sep + "repro_torch" + os.sep + "core" + os.sep,
             os.sep + "repro_torch" + os.sep + "analysis" + os.sep)


def _loc() -> str:
    """file:line of the first caller outside core/analysis — the
    call site a report should point at."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not any(s in fn for s in _SRC_SKIP):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    f = sys._getframe(2)
    return f"{f.f_code.co_filename}:{f.f_lineno}"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker report: what rule fired, where, and against what."""

    rule: str                 # "ww-race" | "wr-race" | "use-after-free"
                              # | "double-free" | "stale-handle"
                              # | "offset-asymmetry" | "nested-drain"
                              # | "signal-race" | "raw-signal"
                              # | "amo-race"
    message: str
    loc: str                  # source location of the flagged access
    other_loc: Optional[str] = None   # the conflicting earlier event

    def __str__(self) -> str:
        s = f"{self.loc}: [{self.rule}] {self.message}"
        if self.other_loc:
            s += f" (conflicts with {self.other_loc})"
        return s


@dataclasses.dataclass
class _PendingWrite:
    """One undrained put interval on one destination PE."""

    dst: int
    name: str                 # symmetric object
    lo: Optional[int]         # row range [lo, hi); None = unknown
    hi: Optional[int]         # (traced offset/extent: no overlap check)
    seq: int
    loc: str
    reported_read: bool = False
    sig_key: Optional[tuple] = None   # (sig name, word offset) guarding
                                      # this write; retired by the wait
    is_sig_word: bool = False         # the signal-word update itself
    amo_key: Optional[tuple] = None   # (name, word offset) of a pending
                                      # AMO; retired by amo_wait — AMOs
                                      # never ww-race each other


def _overlap(a: _PendingWrite, lo, hi) -> bool:
    if a.lo is None or lo is None:
        return False          # unknown extent: conservative no-flag
    return a.lo < hi and lo < a.hi


class ShmemChecker:
    """The happens-before state machine.  One instance is installed
    into the core hooks by :func:`enable`; tests may also drive one
    directly (every ``on_*`` method is a plain call)."""

    def __init__(self):
        self.findings: list[Finding] = []
        self.dropped = 0
        # queue id -> list[_PendingWrite] (retired at fence/quiet)
        self._pending: dict[int, list[_PendingWrite]] = {}
        # queue id -> registered signal words {(name, offset)}: a word
        # becomes a signal word at its first put_signal or wait
        self._sig_words: dict[int, set] = {}
        # queue id -> registered atomic words {(name, offset)}: a word
        # becomes atomic at its first amo_nbi/amo_wait; plain puts
        # touching it afterwards are amo-races
        self._amo_words: dict[int, set] = {}
        self._draining: set[int] = set()
        # heap object lifetime, keyed by symmetric NAME: extents are
        # (offset, nbytes) tuples; a Counter because several heaps may
        # legitimately carry the same object (one per engine/test)
        self._live: dict[str, Counter] = {}
        self._freed: dict[str, dict] = {}   # name -> extent -> free loc
        # per-heap allocation log for Fact-1 symmetry comparison
        self._alloc_log: dict[int, list] = {}

    # ------------------------------------------------------------------
    def _report(self, rule: str, message: str, loc: str,
                other_loc: Optional[str] = None) -> None:
        if len(self.findings) >= MAX_FINDINGS:
            self.dropped += 1
            return
        self.findings.append(Finding(rule, message, loc, other_loc))

    def report(self) -> list[Finding]:
        return list(self.findings)

    def reset(self) -> None:
        self.__init__()

    def observed(self) -> dict:
        """What the hooks have seen since the last reset — registered
        signal and atomic words, heap allocations — so that a run can
        show its checker was armed over the paths it meant to check."""
        return {"signal_words": sum(map(len, self._sig_words.values())),
                "atomic_words": sum(map(len, self._amo_words.values())),
                "allocs": sum(map(len, self._alloc_log.values()))}

    # ------------------------------------------------------------------
    # queue hooks (repro_torch.core.ordering)
    # ------------------------------------------------------------------
    def on_put_nbi(self, queue, handle, data, pairs, offset, seq) -> None:
        loc = _loc()
        self._check_handle_live(handle, "put_nbi", loc)
        lo = hi = None
        try:                  # traced offsets/extents: unknown range
            off = operator.index(offset)
            rows = queue.transport.put_rows(data)
            if rows is not None:
                lo, hi = off, off + int(rows)
        except Exception:
            lo = hi = None
        self._check_raw_signal(queue, handle, lo, hi, seq, loc)
        self._check_amo_word(queue, handle, lo, hi, seq, loc)
        pend = self._pending.setdefault(id(queue), [])
        byte = self._row_bytes(handle)
        for dst in sorted({int(d) for _, d in pairs}):
            for w in pend:
                if w.dst == dst and w.name == handle.name \
                        and not w.is_sig_word and w.amo_key is None \
                        and _overlap(w, lo, hi):
                    olo, ohi = max(w.lo, lo), min(w.hi, hi)
                    brange = (f"bytes [{olo * byte}, {ohi * byte})"
                              if byte else f"rows [{olo}, {ohi})")
                    self._report(
                        "ww-race",
                        f"unordered puts to overlapping range of "
                        f"'{handle.name}' on PE {dst} ({brange}): delivery "
                        f"order is undefined between drains (seqs "
                        f"{w.seq} and {seq}); separate them with "
                        f"fence({dst}) or quiet()", loc, w.loc)
            pend.append(_PendingWrite(dst, handle.name, lo, hi, seq, loc))

    def _check_raw_signal(self, queue, handle, lo, hi, seq,
                          loc: str) -> None:
        """A plain put overlapping a registered signal word bypasses
        the payload-before-signal protocol — a waiter can observe the
        word flip with no payload guarantee behind it."""
        words = self._sig_words.get(id(queue))
        if not words or lo is None:
            return
        for name, off in sorted(words):
            if name == handle.name and lo <= off < hi:
                self._report(
                    "raw-signal",
                    f"plain put_nbi (seq {seq}) writes signal word "
                    f"'{name}'+{off}: signal words carry the "
                    f"payload-before-signal guarantee and must only be "
                    f"written through put_signal_nbi", loc)

    def _check_amo_word(self, queue, handle, lo, hi, seq,
                        loc: str) -> None:
        """A plain put overlapping a registered atomic word races the
        read-modify-write cycle: the shuffle decides whether the blind
        write lands before or after the AMO, so the fetched value (and
        the settled word) is undefined."""
        words = self._amo_words.get(id(queue))
        if not words or lo is None:
            return
        for name, off in sorted(words):
            if name == handle.name and lo <= off < hi:
                self._report(
                    "amo-race",
                    f"plain put_nbi (seq {seq}) writes atomic word "
                    f"'{name}'+{off}: words carrying AMO traffic are "
                    f"linearized by the drain order and must only be "
                    f"updated through amo_nbi", loc)

    def on_amo(self, queue, handle, offset, pairs, seq, op) -> None:
        """One queue AMO issued.  The word becomes a registered atomic
        word; the AMO joins the pending set tagged ``amo_key`` (retired
        by ``amo_wait``).  Pending AMOs on the same word are NOT
        checked against each other — each is its own linearization
        point — but a pending PLAIN put covering the word is an
        amo-race (the mirror of ``_check_amo_word``)."""
        loc = _loc()
        self._check_handle_live(handle, "amo_nbi", loc)
        key = (handle.name, int(offset))
        self._amo_words.setdefault(id(queue), set()).add(key)
        pend = self._pending.setdefault(id(queue), [])
        lo, hi = int(offset), int(offset) + 1
        for dst in sorted({int(d) for _, d in pairs}):
            for w in pend:
                if w.dst == dst and w.name == handle.name \
                        and w.amo_key is None and not w.is_sig_word \
                        and _overlap(w, lo, hi):
                    self._report(
                        "amo-race",
                        f"amo_nbi ({op}, seq {seq}) on '{handle.name}'"
                        f"+{int(offset)} while a plain put (seq {w.seq}) "
                        f"covering the word is pending: the shuffle "
                        f"decides whether the blind write lands before "
                        f"or after the read-modify-write", loc, w.loc)
            pend.append(_PendingWrite(dst, handle.name, lo, hi, seq, loc,
                                      amo_key=key))

    def on_amo_wait(self, queue, handle, offset) -> None:
        """The AMO linearization edge: retire exactly the pending AMOs
        on the named word — everything else stays pending."""
        self._check_reentry(queue,
                            f"amo_wait({handle.name}+{offset})")
        key = (handle.name, int(offset))
        self._amo_words.setdefault(id(queue), set()).add(key)
        pend = self._pending.get(id(queue))
        if pend:
            pend[:] = [w for w in pend if w.amo_key != key]

    def on_signal_reset(self, queue, sig_handle, sig_offset,
                        pairs) -> None:
        """Word recycling through the queue.  Legal only on a RETIRED
        word: pending transfers still guarded by it would have their
        completion evidence wiped before the wait could observe it."""
        loc = _loc()
        self._check_handle_live(sig_handle, "signal_reset", loc)
        key = (sig_handle.name, int(sig_offset))
        self._sig_words.setdefault(id(queue), set()).add(key)
        pend = self._pending.get(id(queue))
        if not pend:
            return
        for w in pend:
            if w.sig_key == key:
                self._report(
                    "signal-race",
                    f"signal_reset of '{key[0]}'+{key[1]} while a "
                    f"transfer guarded by it (seq {w.seq}) is still "
                    f"pending: recycle a word only after its wait "
                    f"retired every guarded put", loc, w.loc)
                break

    def on_put_signal(self, queue, handle, data, pairs, offset,
                      payload_seq, sig_handle, sig_offset,
                      sig_seq) -> None:
        """Record the guarded pair: the payload interval AND the
        signal-word update both join the pending set tagged with the
        word's key, so the matching wait can retire exactly them."""
        loc = _loc()
        self._check_handle_live(handle, "put_signal_nbi", loc)
        self._check_handle_live(sig_handle, "put_signal_nbi", loc)
        key = (sig_handle.name, int(sig_offset))
        self._sig_words.setdefault(id(queue), set()).add(key)
        lo = hi = None
        try:
            off = operator.index(offset)
            rows = queue.transport.put_rows(data)
            if rows is not None:
                lo, hi = off, off + int(rows)
        except Exception:
            lo = hi = None
        pend = self._pending.setdefault(id(queue), [])
        byte = self._row_bytes(handle)
        for dst in sorted({int(d) for _, d in pairs}):
            for w in pend:
                if w.dst == dst and w.name == handle.name \
                        and not w.is_sig_word and _overlap(w, lo, hi):
                    olo, ohi = max(w.lo, lo), min(w.hi, hi)
                    brange = (f"bytes [{olo * byte}, {ohi * byte})"
                              if byte else f"rows [{olo}, {ohi})")
                    self._report(
                        "ww-race",
                        f"unordered puts to overlapping range of "
                        f"'{handle.name}' on PE {dst} ({brange}): delivery "
                        f"order is undefined between drains (seqs "
                        f"{w.seq} and {payload_seq}); separate them with "
                        f"fence({dst}) or quiet()", loc, w.loc)
            pend.append(_PendingWrite(dst, handle.name, lo, hi,
                                      payload_seq, loc, sig_key=key))
            pend.append(_PendingWrite(dst, sig_handle.name,
                                      int(sig_offset), int(sig_offset) + 1,
                                      sig_seq, loc, sig_key=key,
                                      is_sig_word=True))

    def on_signal_wait(self, queue, sig_handle, sig_offset) -> None:
        """The per-transfer happens-before edge: retire EXACTLY the
        pending intervals guarded by this signal word (payloads and the
        word itself) — everything else stays pending."""
        self._check_reentry(
            queue, f"signal_wait_until({sig_handle.name}+{sig_offset})")
        key = (sig_handle.name, int(sig_offset))
        self._sig_words.setdefault(id(queue), set()).add(key)
        pend = self._pending.get(id(queue))
        if pend:
            pend[:] = [w for w in pend if w.sig_key != key]

    def on_get_nbi(self, queue, handle, pairs, offset, size, seq) -> None:
        self._check_handle_live(handle, "get_nbi", _loc())

    def on_fence(self, queue, dst) -> None:
        self._check_reentry(queue, f"fence({dst})")
        pend = self._pending.get(id(queue))
        if not pend:
            return
        if dst is None:
            pend.clear()
        else:
            pend[:] = [w for w in pend if w.dst != int(dst)]

    def on_quiet(self, queue) -> None:
        self._check_reentry(queue, "quiet()")
        self._pending.pop(id(queue), None)

    def on_state_read(self, queue) -> None:
        """The queue's heap state was read.  Any pending put's target
        range is undefined until its drain — flag each once."""
        pend = self._pending.get(id(queue))
        if not pend:
            return
        loc = _loc()
        for w in pend:
            if w.reported_read:
                continue
            w.reported_read = True
            if w.sig_key is not None:
                name, off = w.sig_key
                self._report(
                    "signal-race",
                    f"heap state read while a put-with-signal to "
                    f"'{w.name}' on PE {w.dst} (seq {w.seq}) guarded by "
                    f"'{name}'+{off} is pending: the payload is only "
                    f"defined once signal_wait_until on that word "
                    f"returns", loc, w.loc)
            else:
                self._report(
                    "wr-race",
                    f"heap state read while a put to '{w.name}' on PE "
                    f"{w.dst} (seq {w.seq}) is pending: the target range "
                    f"is undefined until fence/quiet", loc, w.loc)

    @contextlib.contextmanager
    def draining(self, queue):
        self._draining.add(id(queue))
        try:
            yield
        finally:
            self._draining.discard(id(queue))

    def _check_reentry(self, queue, what: str) -> None:
        if id(queue) in self._draining:
            self._report(
                "nested-drain",
                f"{what} re-entered from a drain callback of the same "
                f"CommQueue: completion handling must not block on "
                f"another drain", _loc())

    # ------------------------------------------------------------------
    # heap hooks (repro_torch.core.heap)
    # ------------------------------------------------------------------
    def on_alloc(self, heap, handle) -> None:
        loc = _loc()
        ext = (handle.offset, handle.nbytes)
        self._live.setdefault(handle.name, Counter())[ext] += 1
        self._freed.get(handle.name, {}).pop(ext, None)
        self._alloc_log.setdefault(id(heap), []).append(
            (handle.name, handle.offset, handle.nbytes, loc))

    def on_free(self, heap, name, handle) -> None:
        loc = _loc()
        if handle is None:
            # the heap will raise KeyError; if WE retired this name it
            # is a double free, otherwise it was never tracked (manual
            # handles) and stays the heap's plain error
            freed = self._freed.get(name)
            if freed and not self._live_count(name):
                self._report(
                    "double-free",
                    f"free of symmetric object '{name}' which was "
                    f"already freed", loc, next(iter(freed.values())))
            return
        ext = (handle.offset, handle.nbytes)
        live = self._live.get(name)
        if live and live[ext] > 0:
            live[ext] -= 1
        self._freed.setdefault(name, {})[ext] = loc

    def on_realloc(self, heap, old, new) -> None:
        """In-place resize: the old extent dies, the new one is live.
        (The move path goes through free + alloc and is already
        covered.)"""
        loc = _loc()
        oext, next_ = (old.offset, old.nbytes), (new.offset, new.nbytes)
        if oext != next_:
            live = self._live.get(old.name)
            if live and live[oext] > 0:
                live[oext] -= 1
            self._freed.setdefault(old.name, {})[oext] = loc
        self._live.setdefault(new.name, Counter())[next_] += 1
        self._freed.get(new.name, {}).pop(next_, None)
        self._alloc_log.setdefault(id(heap), []).append(
            (new.name, new.offset, new.nbytes, loc))

    def _live_count(self, name: str) -> int:
        return sum(self._live.get(name, Counter()).values())

    def _check_handle_live(self, handle, op: str, loc: str) -> None:
        name = handle.name
        live = self._live.get(name)
        freed = self._freed.get(name)
        if not live and not freed:
            return            # never heap-tracked (manual SymHandle)
        ext = (handle.offset, handle.nbytes)
        if live is not None and live[ext] > 0:
            return
        if freed and ext in freed:
            kind = ("use-after-free" if not self._live_count(name)
                    else "stale-handle")
            self._report(
                kind,
                f"{op} through handle of '{name}' (offset "
                f"{handle.offset}, {handle.nbytes}B) whose extent was "
                f"freed or moved by realloc", loc, freed[ext])

    # ------------------------------------------------------------------
    # Fact 1 — cross-PE offset symmetry
    # ------------------------------------------------------------------
    def compare_heaps(self, *heaps) -> list[Finding]:
        """Check that identically-driven heaps produced identical
        allocation sequences (name, offset, nbytes).  SPMD makes this
        true by construction for a correct program; a PE-dependent
        branch around an alloc breaks it — the checker reports the
        first divergent allocation with both source locations."""
        out: list[Finding] = []
        logs = [self._alloc_log.get(id(h), []) for h in heaps]
        for i, (a, b) in enumerate(zip(heaps, heaps[1:])):
            la, lb = logs[i], logs[i + 1]
            for j, (ea, eb) in enumerate(zip(la, lb)):
                if ea[:3] != eb[:3]:
                    f = Finding(
                        "offset-asymmetry",
                        f"allocation #{j} diverges across PEs: "
                        f"{ea[0]!r}@{ea[1]} ({ea[2]}B) vs "
                        f"{eb[0]!r}@{eb[1]} ({eb[2]}B) — symmetric "
                        f"allocation must be the same call sequence on "
                        f"every PE (Fact 1)", eb[3], ea[3])
                    out.append(f)
                    break
            else:
                if len(la) != len(lb):
                    k = min(len(la), len(lb))
                    longer = la if len(la) > len(lb) else lb
                    f = Finding(
                        "offset-asymmetry",
                        f"allocation counts diverge across PEs "
                        f"({len(la)} vs {len(lb)}): first unmatched "
                        f"alloc is {longer[k][0]!r}@{longer[k][1]}",
                        longer[k][3])
                    out.append(f)
        for f in out:
            self._report(f.rule, f.message, f.loc, f.other_loc)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _row_bytes(handle) -> int:
        shape = getattr(handle, "shape", ())
        if shape and int(shape[0]) > 0:
            return int(handle.nbytes) // int(shape[0])
        return 0


# ======================================================================
# module-level installation — the zero-cost-when-off switch
# ======================================================================
_CHECKER: Optional[ShmemChecker] = None


def _install(checker: Optional[ShmemChecker]) -> None:
    from repro_torch.core import heap as _heap
    from repro_torch.core import ordering as _ordering
    _ordering._checker = checker
    _heap._checker = checker


def enable() -> ShmemChecker:
    """Install (or return the already-installed) checker into the core
    hooks.  Idempotent; safe to call per-test."""
    global _CHECKER
    if _CHECKER is None:
        _CHECKER = ShmemChecker()
    _install(_CHECKER)
    return _CHECKER


def disable() -> None:
    """Uninstall the hooks (findings are kept until ``reset``)."""
    _install(None)


def is_enabled() -> bool:
    from repro_torch.core import ordering as _ordering
    return _ordering._checker is not None


def get_checker() -> Optional[ShmemChecker]:
    return _CHECKER


def report() -> list[Finding]:
    return _CHECKER.report() if _CHECKER is not None else []


def reset() -> None:
    if _CHECKER is not None:
        _CHECKER.reset()


def compare_heaps(*heaps) -> list[Finding]:
    if _CHECKER is None:
        return []
    return _CHECKER.compare_heaps(*heaps)


@contextlib.contextmanager
def suspended():
    """Temporarily uninstall the hooks (for code that deliberately
    explores racy interleavings, e.g. the ordering property tests)."""
    was = is_enabled()
    disable()
    try:
        yield
    finally:
        if was:
            enable()


@contextlib.contextmanager
def session():
    """enable + fresh state; yields the checker, uninstalls after."""
    chk = enable()
    chk.reset()
    try:
        yield chk
    finally:
        disable()
