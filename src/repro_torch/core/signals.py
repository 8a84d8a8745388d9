"""Put-with-signal: per-transfer completion on the CommQueue (counterpart
of ``repro.core.signals``).

POSH's §3.2 model has two drain points, ``fence`` and ``quiet``, so a
consumer that wants ONE producer's payload pays for everyone else's
outstanding traffic too.  The OpenSHMEM ``shmem_put_signal`` /
``shmem_signal_wait_until`` extension closes that gap:

  * ``put_signal_nbi(queue, handle, data, pairs, sig_handle, value)``
    enqueues the payload put plus a signal-word update delivered AFTER
    the payload in any drain;
  * ``signal_wait_until(queue, sig_handle, cmp, value)`` drains exactly
    the puts guarding that word, payloads first, and nothing else.

Signal words are ordinary symmetric objects: :class:`SignalPad` carves
``n`` of them from a :class:`~repro_torch.core.heap.SymmetricHeap`, so a
ticket's word lives at the same offset on every PE (Fact 1).
"""
from __future__ import annotations

import operator
from typing import TYPE_CHECKING, Optional

import torch

from ..device import resolve
from .heap import SymHandle, SymmetricHeap

if TYPE_CHECKING:                         # avoid a runtime cycle
    from .ordering import CommQueue, HeapState, Pairs

# comparison spellings (SHMEM_CMP_*)
CMP_EQ = "eq"
CMP_NE = "ne"
CMP_GT = "gt"
CMP_GE = "ge"
CMP_LT = "lt"
CMP_LE = "le"

# signal-update ops (SHMEM_SIGNAL_*)
SIGNAL_SET = "set"
SIGNAL_ADD = "add"

_CMPS = {CMP_EQ: operator.eq, CMP_NE: operator.ne, CMP_GT: operator.gt,
         CMP_GE: operator.ge, CMP_LT: operator.lt, CMP_LE: operator.le}


def cmp_ok(cur, cmp: str, value) -> bool:
    """Evaluate one SHMEM_CMP_* comparison against a signal word."""
    try:
        fn = _CMPS[cmp]
    except KeyError:
        raise ValueError(f"unknown signal comparison {cmp!r} "
                         f"(want one of {sorted(_CMPS)})") from None
    return bool(fn(cur, value))


# ======================================================================
# free-function OpenSHMEM spellings
# ======================================================================
def put_signal_nbi(queue: "CommQueue", handle: SymHandle, data,
                   pairs: "Pairs", sig_handle: SymHandle, sig_value, *,
                   offset=0, sig_offset=0, sig_op: str = SIGNAL_SET) -> int:
    """``shmem_put_signal_nbi`` — payload put + guarded signal update
    onto ``queue``; drained per transfer by ``signal_wait_until`` on the
    same word (or by any covering fence/quiet)."""
    return queue.put_signal_nbi(  # shmem: deferred-drain
        handle, data, pairs, sig_handle, sig_value, offset=offset,
        sig_offset=sig_offset, sig_op=sig_op)


def signal_wait_until(queue: "CommQueue", sig_handle: SymHandle,
                      cmp: str, value, *, sig_offset=0,
                      pe: Optional[int] = None) -> "HeapState":
    """``shmem_signal_wait_until`` — delivers exactly the puts guarding
    the named word, then checks PE ``pe``'s settled word against
    ``cmp``/``value`` (raising where the real call would spin
    forever)."""
    return queue.signal_wait_until(sig_handle, cmp, value,
                                   sig_offset=sig_offset, pe=pe)


# ======================================================================
# signal words as symmetric objects
# ======================================================================
class SignalPad:
    """``n`` signal words carved from the symmetric heap — one per
    in-flight handoff ticket.  Tickets recycle words round-robin;
    callers retire (wait on) a word before its slot comes around
    again."""

    def __init__(self, heap: SymmetricHeap, n: int, *,
                 name: str = "sig_words", dtype=torch.int64):
        if n < 1:
            raise ValueError("SignalPad needs at least one word")
        self.n = int(n)
        self.handle: SymHandle = heap.alloc(name, (self.n,), dtype)

    def word(self, ticket: int) -> int:
        """The pad offset of ``ticket``'s signal word."""
        return int(ticket) % self.n

    def zeros(self, n_pe: Optional[int] = None, device=None) -> torch.Tensor:
        """A cleared pad object: one PE's ``(n,)``, or every PE's
        ``(n_pe, n)`` (an initial heap-state value), on ``device`` (the
        card unless the CPU is asked for)."""
        shape = (self.n,) if n_pe is None else (int(n_pe), self.n)
        return torch.zeros(shape, dtype=self.handle.dtype,
                           device=resolve(device))
