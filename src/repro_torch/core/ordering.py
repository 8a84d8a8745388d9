"""The ordered one-sided pipeline: nonblocking put/get with fence/quiet
(counterpart of ``repro.core.ordering``).

This puts the paper's communication and memory model (§3.2) into code:

  * ``put`` completes **locally** as soon as the call returns: the
    payload is a snapshot taken at issue time;
  * remote **delivery** is unordered until an ordering point;
  * ``shmem_fence`` orders delivery *per destination*;
  * ``shmem_quiet`` is the full completion barrier.

``put_nbi``/``get_nbi`` enqueue :class:`PendingPut`/:class:`PendingGet`
records onto a :class:`CommQueue`; nothing moves until a drain point.
Within one drain the delivery order is a deterministic shuffle keyed by
``delivery_seed`` — Python's ``random.Random(delivery_seed).shuffle`` on
the same list as the reference, so one seed gives the reference's
delivery order — and a signal update always lands after its payload.
Put-with-signal (``signal_wait_until``) and AMOs (``amo_wait``) add
per-word drains.

Payloads are stacked ``(n_pe, rows, ...)`` tensors (``(n_pe,)`` for one
row), and the heap state is the port's ``name -> (n_pe, *shape)`` dict.
Data motion is pluggable through a :class:`Transport`:

  PermuteTransport   ``p2p.heap_put``/``heap_get`` rounds on the stacked
                     team (default) — staged by the ``pallas`` backend's
                     copy engine when one is installed.
  LocalTransport     plain loops over the stacked tensors, the oracle.
  InPlaceTransport   the oracle's loops landing each put in the state
                     itself, with the source's rows alone as payload —
                     for queues over large device objects (a pool, a
                     mailbox, a weight stage).
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from . import p2p
from .heap import HeapState, SymHandle
from .teams import TeamAxes

Pairs = Sequence[tuple[int, int]]

# repro_torch.analysis.shmemcheck hook slot.  None when the checker is
# off: an instrumented call site then costs one global load plus an
# is-None test (the analogue of building POSH without _SAFE, §4.7).
# ``shmemcheck.enable()`` installs a checker here and in core.heap.
_checker = None


def _snapshot(data) -> torch.Tensor:
    """An owned copy of a payload, taken at issue (local completion)."""
    return torch.as_tensor(data).clone()


# ======================================================================
# pending-op records
# ======================================================================
@dataclasses.dataclass
class PendingPut:
    """One issued-but-undelivered put.  ``data`` is the issue-time
    snapshot (local completion); ``seq`` is the global issue index.

    A put-with-signal (``CommQueue.put_signal_nbi``) enqueues TWO of
    these: the payload put, and a signal-word update whose ``signal``
    field carries ``(op, value)`` (``data`` is None) and whose
    ``signal_of`` names the payload's seq — the one delivery-order
    constraint the model adds: within any drain the signal lands
    after its payload (see ``_drain_order``)."""

    seq: int
    handle: SymHandle
    data: Any
    pairs: list[tuple[int, int]]
    offset: Any
    signal: Optional[tuple] = None        # (op, value) for signal words
    signal_of: Optional[int] = None       # payload seq this signal guards

    def dsts(self) -> set[int]:
        return {d for _, d in self.pairs}


@dataclasses.dataclass
class PendingGet:
    seq: int
    handle: SymHandle
    pairs: list[tuple[int, int]]
    offset: Any
    size: Optional[int]
    result: "NbiValue"


@dataclasses.dataclass
class PendingAmo:
    """One issued-but-undelivered atomic memory operation
    (``CommQueue.amo_nbi`` — the §4.6 fetch-&-op family on the queue
    path).  An AMO is its own linearization point: within a drain it is
    shuffled with the puts like any other op, and the drain order IS
    the linearization order — two AMOs on the same word are never a
    race, whichever lands first simply linearizes first.  ``result``
    receives the fetched (pre-op) value at delivery.  Drained like a
    signal: ``amo_wait`` on the word retires exactly the AMOs guarding
    it (or any covering fence/quiet).

    ``signal``/``signal_of`` exist only so the drain machinery
    (shuffle fixup, coalescer) can treat the three op classes
    uniformly; an AMO never participates in either."""

    seq: int
    handle: SymHandle
    offset: int
    pairs: list[tuple[int, int]]
    op: str                               # "fadd"|"swap"|"cswap"|"fetch"
    value: Any = None
    cond: Any = None
    result: Optional["NbiValue"] = None
    signal: Optional[tuple] = None        # never set; drain-shape parity
    signal_of: Optional[int] = None

    def dsts(self) -> set[int]:
        return {d for _, d in self.pairs}


@dataclasses.dataclass
class PendingReduce:
    """A nonblocking collective reduction (the train-loop user of the
    queue).  Delivered at ``quiet()`` in issue order — reductions are
    collectives, not one-sided writes, so the paper's unordered-delivery
    freedom does not apply to them; issue order keeps the float
    reduction bit-identical to the blocking path."""

    seq: int
    data: Any
    deliver: Callable[[Any], Any]
    result: "NbiValue"


class NbiValue:
    """Deferred result of a nonblocking get/reduction.  ``value()`` is
    legal only after the owning queue's ``quiet()`` — reading earlier is
    the programming error the paper's model forbids, and raising is the
    safe-mode analogue of the undefined behaviour you would get from a
    real NIC."""

    __slots__ = ("_value", "_ready", "_tag")

    def __init__(self, tag: str = "nbi"):
        self._value = None
        self._ready = False
        self._tag = tag

    def _deliver(self, value) -> None:
        self._value = value
        self._ready = True

    @property
    def ready(self) -> bool:
        return self._ready

    def value(self):
        if not self._ready:
            raise RuntimeError(
                f"{self._tag}: nonblocking result read before quiet() — "
                "the paper's model leaves this undefined; call "
                "CommQueue.quiet() first")
        return self._value


# ======================================================================
# transports — who actually moves the bytes at a drain point
# ======================================================================
class Transport:
    """Delivery mechanism for drained ops.  ``state`` is a HeapState of
    stacked ``(n_pe, ...)`` tensors under both transports of the port.

    ``put_rows``/``concat_puts`` describe the transport's payload layout
    to the queue's drain-time coalescer: how many object rows one put
    covers, and how two payloads concatenate into one.  A transport that
    returns ``None`` from ``concat_puts`` opts out of coalescing."""

    def put(self, state: HeapState, handle: SymHandle, data, pairs: Pairs,
            team: TeamAxes, offset) -> HeapState:
        raise NotImplementedError

    def get(self, state: HeapState, handle: SymHandle, pairs: Pairs,
            team: TeamAxes, offset, size: Optional[int]):
        raise NotImplementedError

    def put_signal(self, state: HeapState, handle: SymHandle, value,
                   pairs: Pairs, team: TeamAxes, offset, op: str) -> HeapState:
        """Deliver one signal-word update (``shmem_put_signal``'s
        second half).  ``op`` is ``"set"`` (overwrite) or ``"add"``
        (fetch-accumulate, SHMEM_SIGNAL_ADD)."""
        raise NotImplementedError

    def amo(self, state: HeapState, handle: SymHandle, op: str, value,
            cond, pairs: Pairs, team: TeamAxes, offset):
        """Deliver one atomic memory operation on ``handle[offset]`` of
        the owner PE (the ``dst`` of the single pair) and return
        ``(new_state, old_value)`` — the fetched pre-op value the
        requester observes.  ``op``: ``"fadd"``/``"swap"``/``"cswap"``
        (``cond`` used)/``"fetch"`` (read-only)."""
        raise NotImplementedError

    def put_rows(self, data) -> Optional[int]:
        return None                       # unknown layout: no coalescing

    def concat_puts(self, datas):
        return None

    def snapshot(self, data, dst) -> torch.Tensor:
        """A put's issue-time copy of ``data`` (local completion);
        ``dst`` is the destination object's state entry, or None."""
        return _snapshot(data)


class PermuteTransport(Transport):
    """The real data path: one ``p2p`` round per delivery over the
    stacked team, addressed through the symmetric heap (Corollary 1) —
    so under the ``pallas`` backend's stager every delivered payload is
    copied by the CUDA copy engine.  State and payloads are stacked,
    ``(n_pe, rows, ...)``, as under :class:`LocalTransport`."""

    def put(self, state, handle, data, pairs, team, offset):
        data = torch.as_tensor(data, device=state[handle.name].device)
        return p2p.heap_put(state, handle, data, pairs, team, offset=offset)

    def get(self, state, handle, pairs, team, offset, size):
        return p2p.heap_get(state, handle, pairs, team, offset=offset,
                            size=size)

    def put_signal(self, state, handle, value, pairs, team, offset, op):
        if op == "add":
            # fetch-accumulate needs a remote read; the permute path is
            # write-only one round, so additive signals stay local-only
            raise NotImplementedError(
                "PermuteTransport delivers 'set' signals only")
        buf = state[handle.name]
        data = torch.full((buf.shape[0], 1), value, dtype=buf.dtype,
                          device=buf.device)
        return p2p.heap_put(state, handle, data, pairs, team, offset=offset)

    def amo(self, state, handle, op, value, cond, pairs, team, offset):
        # a queue AMO is a remote read-modify-write round trip; the
        # permute path is write-only one round.  Linearizable atomics on
        # the stacked team are the owner-computes collectives in
        # core.atomics (same precedent as the 'add' signal above).
        raise NotImplementedError(
            "PermuteTransport has no AMO round — use the owner-computes "
            "atomics in repro_torch.core.atomics")

    def put_rows(self, data):
        return _put_rows(data)

    def concat_puts(self, datas):
        return _concat_puts(datas)


class LocalTransport(Transport):
    """Whole-system simulation: every state tensor carries a leading PE
    axis, so one process sees all ``n_pe`` heaps at once, and each
    delivery is a plain loop over its pairs.  This is the oracle the
    property tests replay interleavings against, and the one
    :class:`PermuteTransport` is held to."""

    def __init__(self, n_pe: int):
        self.n_pe = int(n_pe)

    def put(self, state, handle, data, pairs, team, offset):
        out = dict(state)
        out[handle.name] = buf = state[handle.name].clone()
        data = torch.as_tensor(data)
        rows = data.shape[1] if data.dim() > 1 else 1
        for s, d in pairs:
            buf[d, offset:offset + rows] = data[s]
        return out

    def get(self, state, handle, pairs, team, offset, size):
        buf = state[handle.name]
        size = buf.shape[1] - offset if size is None else size
        out = buf.new_zeros((self.n_pe, size) + tuple(buf.shape[2:]))
        for owner, reader in pairs:
            out[reader] = buf[owner, offset:offset + size]
        return out

    def put_signal(self, state, handle, value, pairs, team, offset, op):
        out = dict(state)
        out[handle.name] = buf = state[handle.name].clone()
        for _, d in pairs:
            if op == "add":
                buf[d, offset] += value
            else:
                buf[d, offset] = value
        return out

    def amo(self, state, handle, op, value, cond, pairs, team, offset):
        out = dict(state)
        out[handle.name] = buf = state[handle.name].clone()
        flat = buf.reshape(buf.shape[0], -1)
        (_, owner), = pairs               # one requester, one owner
        old = flat[owner, offset].item()
        if op == "fadd":
            flat[owner, offset] = old + value
        elif op == "swap":
            flat[owner, offset] = value
        elif op == "cswap":
            if old == cond:
                flat[owner, offset] = value
        elif op != "fetch":
            raise ValueError(f"unknown AMO op {op!r}")
        return out, old

    def put_rows(self, data):
        return _put_rows(data)

    def concat_puts(self, datas):
        return _concat_puts(datas)


class InPlaceTransport(LocalTransport):
    """``LocalTransport`` that lands each put in the state entry itself,
    on its device: no copy of the object per put.  A put's payload is
    the source's rows alone, ``(1, rows, ...)`` (a one-sided put carries
    what its source holds; the whole-system stack of the oracle would be
    ``n_pe`` times the bytes, all zeros but one), and it lands in PE
    ``d``'s rows of the entry, row block ``d - first_pe``: an entry may
    hold row blocks for the PEs from ``first_pe`` on alone.  An entry is
    a stacked tensor or a list of per-PE tensors (each PE's object its
    own allocation, so one PE's copy can be freed apart from the rest).

    The issue-time snapshot is taken on the destination's device: a
    payload on the host crosses the bus once.  From pinned host memory
    the copy is asynchronous on the current stream, so the put that
    lands it, and every forward queued after it, follow it in stream
    order."""

    def __init__(self, n_pe: int, first_pe: int = 0):
        super().__init__(n_pe)
        self.first_pe = int(first_pe)

    def snapshot(self, data, dst) -> torch.Tensor:
        data = torch.as_tensor(data)
        dev = (dst[0] if isinstance(dst, list) else dst).device
        return data.to(dev, copy=True, non_blocking=data.is_pinned())

    def put(self, state, handle, data, pairs, team, offset):
        buf = state[handle.name]
        rows = _put_rows(data)
        for _, d in pairs:
            buf[d - self.first_pe][offset:offset + rows] = data[0]
        return state


def _put_rows(data) -> int:
    """Rows one stacked ``(n_pe, rows, ...)`` payload covers."""
    return int(data.shape[1]) if data.dim() > 1 else 1


def _concat_puts(datas):
    datas = [d[:, None] if d.dim() == 1 else d for d in datas]
    return torch.cat(datas, dim=1)


# ======================================================================
# the queue
# ======================================================================
class CommQueue:
    """Ordered communication pipeline over a team.

    ``put_nbi``/``get_nbi`` enqueue; ``fence``/``quiet`` are the
    drain points (the paper's §3.2 ordering model), plus
    ``signal_wait_until`` as the per-transfer completion the
    put-with-signal extension adds (``core.signals``).  The queue owns
    the heap state between drains::

        q = CommQueue(team, heap.zeros_state(n_pe))
        q.put_nbi(h, x, pairs)            # returns immediately
        q.put_nbi(h, y, pairs2)           # unordered wrt the first ...
        q.fence()                         # ... until here
        q.put_nbi(h, z, pairs)            # ordered after x and y
        state = q.quiet()                 # everything delivered

    ``delivery_seed`` keys the intra-drain delivery shuffle: every seed
    is a legal execution under the model; ``None`` means issue order.
    Tests sweep seeds to check that programs relying only on fence/quiet
    ordering are seed-invariant and that anything stronger is not
    accidentally guaranteed.
    """

    def __init__(self, team: TeamAxes, state: Optional[HeapState] = None,
                 *, transport: Optional[Transport] = None,
                 delivery_seed: Optional[int] = None):
        self.team = team
        self._state: HeapState = dict(state or {})
        self.transport = transport or PermuteTransport()
        self.delivery_seed = delivery_seed
        self._puts: list[PendingPut] = []
        self._gets: list[PendingGet] = []
        self._reduces: list[PendingReduce] = []
        # signal-word guard map: (sig object name, word offset) -> the
        # pending seqs (payload AND signal updates) a wait on that word
        # retires.  signal_wait_until pops its key — per-transfer
        # completion, the third drain class next to fence/quiet.
        self._sig_guards: dict[tuple[str, int], list[int]] = {}
        # AMO guard map, same shape: (object name, word offset) -> the
        # pending AMO seqs an amo_wait on that word retires.
        self._amo_guards: dict[tuple[str, int], list[int]] = {}
        self._seq = 0
        self._stats = {"puts": 0, "gets": 0, "reduces": 0, "fences": 0,
                       "quiets": 0, "drained": 0, "max_pending": 0,
                       "coalesced": 0, "signal_puts": 0,
                       "signal_waits": 0, "signal_resets": 0,
                       "amos": 0, "amo_waits": 0}
        # named counter windows (``phase``): accumulated stat deltas per
        # phase name, e.g. the weight hot-swap attributing its traffic
        self._phase_stats: dict[str, dict] = {}
        self._phase: Optional[tuple] = None

    # ------------------------------------------------------------------
    # issue side — returns immediately (local completion)
    # ------------------------------------------------------------------
    def put_nbi(self, handle: SymHandle, data, pairs: Pairs,
                offset=0) -> int:
        """``shmem_put_nbi``: enqueue a put.  Completes locally now —
        ``data`` is snapshotted by value; remote delivery waits for the
        next ``fence``/``quiet`` covering its destinations.  Returns the
        issue sequence number (for debugging/stats)."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        # tensors are mutable: snapshot now so the caller may reuse the
        # buffer immediately (local completion)
        data = self.transport.snapshot(data, self._state.get(handle.name))
        op = PendingPut(self._next_seq(), handle, data, pairs, offset)
        self._puts.append(op)
        self._stats["puts"] += 1
        self._track_pending()
        if _checker is not None:
            _checker.on_put_nbi(self, handle, data, pairs, offset, op.seq)
        return op.seq

    def put_signal_nbi(self, handle: SymHandle, data, pairs: Pairs,
                       sig_handle: SymHandle, sig_value, *, offset=0,
                       sig_offset=0, sig_op: str = "set") -> int:
        """``shmem_put_signal_nbi``: enqueue the payload put PLUS a
        signal-word update that is delivered only AFTER the payload —
        the one intra-drain ordering edge the model adds on top of
        §3.2's unordered delivery.  ``sig_handle``/``sig_offset`` name
        one word of a symmetric signal object (see ``core.signals``);
        ``sig_op`` is ``"set"`` or ``"add"`` (SHMEM_SIGNAL_SET/ADD).
        The pair is drained by ``signal_wait_until`` on that word (or
        by any fence/quiet covering it).  Returns the payload's issue
        seq."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        if sig_op not in ("set", "add"):
            raise ValueError(f"put_signal_nbi: bad sig_op {sig_op!r} "
                             "(want 'set' or 'add')")
        # local completion (see put_nbi)
        data = self.transport.snapshot(data, self._state.get(handle.name))
        payload = PendingPut(self._next_seq(), handle, data, pairs, offset)
        self._puts.append(payload)
        sig = PendingPut(self._next_seq(), sig_handle, None, pairs,
                         int(sig_offset), signal=(sig_op, sig_value),
                         signal_of=payload.seq)
        self._puts.append(sig)
        self._stats["puts"] += 1
        self._stats["signal_puts"] += 1
        key = (sig_handle.name, int(sig_offset))
        self._sig_guards.setdefault(key, []).extend((payload.seq, sig.seq))
        self._track_pending()
        if _checker is not None:
            _checker.on_put_signal(self, handle, data, pairs, offset,
                                   payload.seq, sig_handle, int(sig_offset),
                                   sig.seq)
        return payload.seq

    def amo_nbi(self, handle: SymHandle, op: str, pairs: Pairs, *,
                value=None, cond=None, offset=0) -> NbiValue:
        """Enqueue one atomic memory operation (§4.6 fetch-&-op on the
        queue path): ``op`` is ``"fadd"`` (add ``value``), ``"swap"``
        (write ``value``), ``"cswap"`` (write ``value`` iff the word
        equals ``cond``) or ``"fetch"`` (read only).  ``pairs`` is ONE
        ``(requester, owner)`` pair — the word ``handle[offset]`` on
        the owner's heap is the linearization cell.

        Completion semantics: the AMO is its own linearization point.
        It is delivered — atomically, at one place in the intra-drain
        shuffle — by the next ``amo_wait`` on its word, or by any
        covering ``fence``/``quiet``; the returned :class:`NbiValue`
        then holds the fetched pre-op value.  Two pending AMOs on one
        word are NOT a race (the drain order linearizes them); an AMO
        overlapping a plain ``put_nbi`` IS.
        """
        pairs = [(int(s), int(d)) for s, d in pairs]
        if len(pairs) != 1:
            raise ValueError(
                f"amo_nbi[{handle.name}]: an AMO targets exactly one "
                f"(requester, owner) pair, got {len(pairs)}")
        if op not in ("fadd", "swap", "cswap", "fetch"):
            raise ValueError(f"amo_nbi: unknown op {op!r} (want fadd/"
                             "swap/cswap/fetch)")
        if op == "cswap" and cond is None:
            raise ValueError("amo_nbi: cswap needs cond")
        if op in ("fadd", "swap", "cswap") and value is None:
            raise ValueError(f"amo_nbi: {op} needs value")
        res = NbiValue(f"amo_nbi[{handle.name}:{op}]")
        amo = PendingAmo(self._next_seq(), handle, int(offset), pairs,
                         op, value, cond, res)
        self._puts.append(amo)
        self._stats["amos"] += 1
        self._amo_guards.setdefault((handle.name, int(offset)),
                                    []).append(amo.seq)
        self._track_pending()
        if _checker is not None:
            _checker.on_amo(self, handle, int(offset), pairs, amo.seq, op)
        return res

    def get_nbi(self, handle: SymHandle, pairs: Pairs, offset=0,
                size: Optional[int] = None) -> NbiValue:
        """``shmem_get_nbi``: enqueue a get.  The returned
        :class:`NbiValue` becomes readable after ``quiet()``; it
        observes every put delivered by that quiet (gets are satisfied
        after the put drain, the conservative reading of the model).

        ``size=None`` means "the rest of the object from ``offset``" —
        resolved here (statically) so both transports see the same
        concrete extent; an offset that is not an int needs an
        explicit size."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        if size is None:
            if not isinstance(offset, (int, np.integer)):
                raise ValueError(
                    f"get_nbi[{handle.name}]: explicit size required "
                    "when offset is not an int")
            size = int(handle.shape[0]) - int(offset)
            if size <= 0:
                raise ValueError(
                    f"get_nbi[{handle.name}]: offset {offset} leaves no "
                    f"rows in object of {handle.shape[0]}")
        res = NbiValue(f"get_nbi[{handle.name}]")
        op = PendingGet(self._next_seq(), handle, pairs, offset, size, res)
        self._gets.append(op)
        self._stats["gets"] += 1
        self._track_pending()
        if _checker is not None:
            _checker.on_get_nbi(self, handle, pairs, offset, size, op.seq)
        return res

    def allreduce_nbi(self, x, deliver: Callable[[Any], Any]) -> NbiValue:
        """Nonblocking collective reduction: ``deliver`` (e.g. a bound
        ``Communicator.psum``) runs at ``quiet()``.  Issue order is
        preserved across reductions so the drained program is
        bit-identical to the blocking sequence of the same calls —
        the property the overlapped training path is tested for."""
        res = NbiValue("allreduce_nbi")
        op = PendingReduce(self._next_seq(), x, deliver, res)
        self._reduces.append(op)
        self._stats["reduces"] += 1
        self._track_pending()
        return res

    # ------------------------------------------------------------------
    # drain side — fence / quiet, the only ordering points
    # ------------------------------------------------------------------
    def fence(self, dst: Optional[int] = None) -> None:
        """``shmem_fence``: order puts per destination.  Every pending
        put targeting ``dst`` (every destination when None) is delivered
        before this call returns, hence before anything issued later —
        delivery-at-fence is the strongest legal implementation of the
        paper's ordering-only guarantee."""
        if _checker is not None:
            _checker.on_fence(self, dst)
        self._stats["fences"] += 1
        if dst is None:
            todo, keep = self._puts, []
        else:
            todo = [p for p in self._puts if dst in p.dsts()]
            keep = [p for p in self._puts if dst not in p.dsts()]
        self._puts = keep
        self._deliver_puts(todo)

    def quiet(self) -> HeapState:
        """``shmem_quiet``: the full completion barrier.  Delivers every
        pending put (shuffled within the drain — they are mutually
        unordered), then satisfies gets against the settled state, then
        runs nonblocking reductions in issue order.  Returns the heap
        state; afterwards the queue is empty and every NbiValue is
        readable."""
        if _checker is not None:
            _checker.on_quiet(self)
            with _checker.draining(self):
                return self._quiet_impl()
        return self._quiet_impl()

    def _quiet_impl(self) -> HeapState:
        self._stats["quiets"] += 1
        todo, self._puts = self._puts, []
        self._sig_guards.clear()          # everything delivers below
        self._amo_guards.clear()
        self._deliver_puts(todo)
        gets, self._gets = self._gets, []
        for g in gets:
            val = self.transport.get(self._state, g.handle, g.pairs,
                                     self.team, g.offset, g.size)
            g.result._deliver(val)
            self._stats["drained"] += 1
        reduces, self._reduces = self._reduces, []
        for r in sorted(reduces, key=lambda r: r.seq):
            r.result._deliver(r.deliver(r.data))
            r.data = None                 # the payload's memory goes now
            self._stats["drained"] += 1
        return self._state

    def signal_wait_until(self, sig_handle: SymHandle, cmp: str, value,
                          *, sig_offset=0, pe: Optional[int] = None
                          ) -> HeapState:
        """``shmem_signal_wait_until``: the per-transfer drain point.
        Delivers EXACTLY the pending puts guarding the named signal
        word — each payload before its signal update — and nothing
        else: every unrelated pending put stays pending, which is what
        makes this cheaper than a quiet (and what the property test
        pins: a satisfied wait implies the guarded payload is visible,
        and ONLY that payload).

        ``cmp`` is one of ``core.signals``'s CMP_* spellings; ``pe``
        names whose heap to check under a whole-system transport
        (LocalTransport).  When the settled word still fails the
        comparison — nothing pending could ever satisfy it — the real
        call would spin forever, so this raises instead.  Returns the
        heap state."""
        if _checker is not None:
            _checker.on_signal_wait(self, sig_handle, int(sig_offset))
        self._stats["signal_waits"] += 1
        key = (sig_handle.name, int(sig_offset))
        seqs = set(self._sig_guards.pop(key, ()))
        if seqs:
            todo = [p for p in self._puts if p.seq in seqs]
            self._puts = [p for p in self._puts if p.seq not in seqs]
            self._deliver_puts(todo)
        buf = self._state.get(sig_handle.name)
        if isinstance(buf, torch.Tensor) and pe is not None:
            from .signals import cmp_ok
            cur = buf[int(pe), int(sig_offset)]
            if not cmp_ok(int(cur), cmp, int(value)):
                raise RuntimeError(
                    f"signal_wait_until[{sig_handle.name}+{sig_offset}]: "
                    f"word is {int(cur)}, fails {cmp} {int(value)} with "
                    "no guarded put pending — this wait would block "
                    "forever")
        return self._state

    def amo_wait(self, handle: SymHandle, *, offset=0) -> HeapState:
        """The AMO drain point, ``signal_wait_until``'s sibling:
        delivers EXACTLY the pending AMOs targeting the named word —
        shuffled among themselves, each one an atomic linearization
        point — and nothing else.  Every unrelated pending op stays
        pending, so completing an allocator's counter traffic never
        costs a tick-global quiet (the lock-free-scheduling contract:
        ``stats()["quiets"]`` stays 0 on an allocator queue).  After
        the call every retired AMO's :class:`NbiValue` is readable.
        Returns the heap state."""
        if _checker is not None:
            _checker.on_amo_wait(self, handle, int(offset))
        self._stats["amo_waits"] += 1
        seqs = set(self._amo_guards.pop((handle.name, int(offset)), ()))
        if seqs:
            todo = [p for p in self._puts if p.seq in seqs]
            self._puts = [p for p in self._puts if p.seq not in seqs]
            self._deliver_puts(todo)
        return self._state

    def signal_reset(self, sig_handle: SymHandle, pairs: Pairs, *,
                     sig_offset=0, value=0) -> HeapState:
        """Recycle a retired signal/counter word: write ``value``
        (default 0) THROUGH the transport, immediately — not by
        host-side mutation of the state dict, so the write exists in
        the queue's memory model.  Only legal once the word's guarded
        transfers are all retired (resetting under in-flight guards is
        a signal race).
        Counted under ``signal_resets``, never ``signal_puts`` — a
        reset is word housekeeping, not a transfer."""
        pairs = [(int(s), int(d)) for s, d in pairs]
        if _checker is not None:
            _checker.on_signal_reset(self, sig_handle, int(sig_offset),
                                     pairs)
        self._stats["signal_resets"] += 1
        self._state = self.transport.put_signal(
            self._state, sig_handle, value, pairs, self.team,
            int(sig_offset), "set")
        return self._state

    # ------------------------------------------------------------------
    def _deliver_puts(self, ops: list[PendingPut]) -> None:
        for op in self._coalesce(self._drain_order(ops)):
            if isinstance(op, PendingAmo):
                self._state, old = self.transport.amo(
                    self._state, op.handle, op.op, op.value, op.cond,
                    op.pairs, self.team, op.offset)
                op.result._deliver(old)
            elif op.signal is not None:
                sig_op, val = op.signal
                self._state = self.transport.put_signal(
                    self._state, op.handle, val, op.pairs, self.team,
                    op.offset, sig_op)
            else:
                self._state = self.transport.put(
                    self._state, op.handle, op.data, op.pairs, self.team,
                    op.offset)
            self._stats["drained"] += 1

    def _coalesce(self, ops: list[PendingPut]) -> list[PendingPut]:
        """Drain-time coalescing: merge runs of *adjacent-in-delivery-
        order* puts that target the same object through the same pair
        list and cover contiguous row ranges into ONE transport round.
        Merging only adjacent ops is semantics-preserving under any
        delivery order (nothing can interleave inside a run), so the
        fence/quiet model is untouched — the drain just issues fewer,
        larger permute rounds (the batch is already in hand here).
        Traced offsets opt out (contiguity is not statically known)."""
        if len(ops) < 2:
            return ops
        out: list[PendingPut] = []
        run: list[PendingPut] = []
        run_rows = 0

        def flush():
            nonlocal run, run_rows
            if len(run) > 1:
                merged = self.transport.concat_puts([o.data for o in run])
                if merged is not None:
                    self._stats["coalesced"] += len(run) - 1
                    out.append(PendingPut(run[0].seq, run[0].handle, merged,
                                          run[0].pairs, run[0].offset))
                else:
                    out.extend(run)
            else:
                out.extend(run)
            run, run_rows = [], 0

        for op in ops:
            if isinstance(op, PendingAmo) or op.signal is not None:
                flush()                   # AMOs and signal words are
                out.append(op)            # their own rounds, never merged
                continue
            rows = (self.transport.put_rows(op.data)
                    if isinstance(op.offset, (int, np.integer)) else None)
            if rows is None:
                flush()
                out.append(op)
                continue
            if (run and op.handle.name == run[0].handle.name
                    and op.pairs == run[0].pairs
                    and int(op.offset) == int(run[0].offset) + run_rows):
                run.append(op)
                run_rows += rows
            else:
                flush()
                run, run_rows = [op], rows
        flush()
        return out

    def _drain_order(self, ops: list[PendingPut]) -> list[PendingPut]:
        """Intra-drain delivery order: mutually unordered by the model,
        so any permutation is legal — EXCEPT that a signal-word update
        lands after the payload it guards (put-with-signal's one
        promise, restored by ``_signal_fixup`` after the shuffle).
        ``delivery_seed`` picks one deterministically; None keeps issue
        order (also legal, and payload-before-signal by issue)."""
        if self.delivery_seed is None or len(ops) < 2:
            return ops
        ops = list(ops)
        random.Random(self.delivery_seed).shuffle(ops)
        return self._signal_fixup(ops)

    @staticmethod
    def _signal_fixup(ops: list[PendingPut]) -> list[PendingPut]:
        """Move every signal update whose payload is in the same drain
        to just after that payload, preserving the shuffled order of
        everything else (the minimal repair: any shuffle with the
        constraint applied is still a legal delivery order)."""
        present = {op.seq for op in ops}
        emitted: set[int] = set()
        held: dict[int, list[PendingPut]] = {}
        out: list[PendingPut] = []

        def emit(op: PendingPut) -> None:
            out.append(op)
            emitted.add(op.seq)
            for sig in held.pop(op.seq, ()):
                emit(sig)

        for op in ops:
            if (op.signal_of is not None and op.signal_of in present
                    and op.signal_of not in emitted):
                held.setdefault(op.signal_of, []).append(op)
            else:
                emit(op)
        return out

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _track_pending(self) -> None:
        self._stats["max_pending"] = max(self._stats["max_pending"],
                                         self.pending_ops())

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def state(self) -> HeapState:
        """The heap state as of the last drain.  Pending (undelivered)
        ops are NOT visible here — that is the point (and reading it
        with puts in flight is the wr-race shmemcheck flags)."""
        if _checker is not None:
            _checker.on_state_read(self)
        return self._state

    def pending_ops(self) -> int:
        return len(self._puts) + len(self._gets) + len(self._reduces)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute this queue's counter deltas to a named phase while
        the context is open.  Phases accumulate across entries, so a
        caller that re-enters once per serving tick (the weight
        hot-swap streamer) gets ONE running account of the traffic and
        drains it issued — ``stats()["phases"][name]["quiets"]`` is the
        authoritative "did this subsystem pay a global drain" counter
        (the ``swap_extra_quiets == 0`` pin).  Nesting is rejected: a
        delta can only be attributed once."""
        if self._phase is not None:
            raise RuntimeError(
                f"CommQueue.phase({name!r}): phase "
                f"{self._phase[0]!r} is still open — phases do not nest")
        before = dict(self._stats)
        self._phase = (name, before)
        try:
            yield self
        finally:
            self._phase = None
            acc = self._phase_stats.setdefault(
                name, {k: 0 for k in self._stats})
            for k, v in self._stats.items():
                acc[k] = acc.get(k, 0) + (v - before.get(k, 0))

    def phase_stats(self, name: str) -> dict:
        """The accumulated counter deltas of one named phase (all zeros
        if the phase never ran)."""
        base = {k: 0 for k in self._stats}
        base.update(self._phase_stats.get(name, {}))
        return base

    def stats(self) -> dict:
        """Counter snapshot.  On top of the raw counters, exposes the
        derived fields analysis tooling keys on: ``drains`` (fences +
        quiets — total happens-before edges inserted) and
        ``pending_by_dst`` (undelivered put count per destination PE,
        the live racy-window footprint)."""
        out = dict(self._stats)
        out["drains"] = out["fences"] + out["quiets"]
        out["phases"] = {n: dict(d) for n, d in self._phase_stats.items()}
        by_dst: dict[int, int] = {}
        for p in self._puts:
            for d in p.dsts():
                by_dst[d] = by_dst.get(d, 0) + 1
        out["pending_by_dst"] = by_dst
        return out


# ======================================================================
# free-function OpenSHMEM spellings
# ======================================================================
def put_nbi(queue: CommQueue, handle: SymHandle, data, pairs: Pairs,
            offset=0) -> int:
    """``shmem_put_nbi`` — nonblocking put onto ``queue``."""
    return queue.put_nbi(handle, data, pairs, offset=offset)  # shmem: deferred-drain


def get_nbi(queue: CommQueue, handle: SymHandle, pairs: Pairs, offset=0,
            size: Optional[int] = None) -> NbiValue:
    """``shmem_get_nbi`` — nonblocking get from ``queue``."""
    return queue.get_nbi(handle, pairs, offset=offset, size=size)  # shmem: deferred-drain


def fence(queue: CommQueue, dst: Optional[int] = None) -> None:
    """``shmem_fence`` — per-destination ordering point."""
    queue.fence(dst)


def quiet(queue: CommQueue) -> HeapState:
    """``shmem_quiet`` — full completion barrier."""
    return queue.quiet()
