"""repro_torch.core — POSH (Paris OpenSHMEM) on the stacked team: every
PE's shard on a leading axis of one tensor on one card (counterpart of
``repro.core``, with its public names).

    SymmetricHeap, SymHandle        symmetric heap + allocator (§3.1, §4.1)
    put, get, ring_shift            one-sided p2p rounds (§3.2)
    heap_put, heap_get, heap_p/g    offset-addressed remote access (Cor. 1)
    CommQueue, put_nbi, get_nbi,
    fence, quiet                    ordered nonblocking pipeline (§3.2)
    put_signal_nbi,
    signal_wait_until, SignalPad    put-with-signal per-transfer completion
    barrier_all, broadcast,
    fcollect, reduce, allreduce,
    reduce_scatter, alltoall        collectives on p2p (§4.5)
    atomic_fadd/swap/cswap,
    TicketLock                      §4.6 adaptation (owner-computes)
    atomic_*_nbi, amo_wait          §4.6 on the queue path
    Team, ActiveSet                 PE addressing (§4.7)
    safe_mode, debug_mode           _SAFE/_DEBUG modes (§4.7)
"""
from .atomics import (TicketLock, amo_wait, atomic_cswap,
                      atomic_cswap_nbi, atomic_fadd, atomic_fadd_nbi,
                      atomic_fetch_nbi, atomic_swap, atomic_swap_nbi)
from .collectives import (allreduce, alltoall, barrier_all, broadcast,
                          fcollect, reduce, reduce_scatter)
from .heap import HeapState, SymHandle, SymmetricHeap
from .ordering import (CommQueue, LocalTransport, NbiValue, PermuteTransport,
                       Transport, fence, get_nbi, put_nbi, quiet)
from .p2p import get, heap_g, heap_get, heap_p, heap_put, put, ring_shift
from .safety import (PoshSafetyError, debug_mode, is_debug, is_safe,
                     safe_mode)
from .signals import (CMP_EQ, CMP_GE, CMP_GT, CMP_LE, CMP_LT, CMP_NE,
                      SIGNAL_ADD, SIGNAL_SET, SignalPad, cmp_ok,
                      put_signal_nbi, signal_wait_until)
from .teams import ActiveSet, Team, TeamAxes, my_pe, team_size

__all__ = [
    "SymmetricHeap", "SymHandle", "HeapState",
    "put", "get", "ring_shift", "heap_put", "heap_get", "heap_p", "heap_g",
    "CommQueue", "NbiValue", "Transport", "PermuteTransport",
    "LocalTransport", "put_nbi", "get_nbi", "fence", "quiet",
    "put_signal_nbi", "signal_wait_until", "SignalPad", "cmp_ok",
    "CMP_EQ", "CMP_NE", "CMP_GT", "CMP_GE", "CMP_LT", "CMP_LE",
    "SIGNAL_SET", "SIGNAL_ADD",
    "barrier_all", "broadcast", "fcollect", "reduce", "allreduce",
    "reduce_scatter", "alltoall",
    "atomic_fadd", "atomic_swap", "atomic_cswap", "TicketLock",
    "atomic_fetch_nbi", "atomic_fadd_nbi", "atomic_swap_nbi",
    "atomic_cswap_nbi", "amo_wait",
    "Team", "ActiveSet", "TeamAxes", "my_pe", "team_size",
    "safe_mode", "debug_mode", "is_safe", "is_debug", "PoshSafetyError",
]
