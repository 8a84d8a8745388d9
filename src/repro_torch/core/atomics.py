"""Atomics and locks on the symmetric heap (paper §4.6), owner-computes,
on the stacked team (counterpart of ``repro.core.atomics``).

POSH gets atomics from Boost's atomic functors and mutual exclusion from
named mutexes.  The reference adapts them as deterministic owner-side
serialization: every requesting PE contributes its operand, requests are
linearized in PE-rank order, each requester receives the value the cell
held just before its own operation, and the owner's cell ends at the
value after all of them.  The port computes the same on the stacked
team: operands are gathered with ``collectives.fcollect`` and the
owner's cell broadcast with ``collectives.broadcast``, as the reference
does, and each PE's result is read from its own row.

``value``/``participate``/``cond`` are one scalar per PE (``(n_pe,)``)
or one for all; ``state`` tensors are stacked ``(n_pe, *shape)``.

The host-side family on the :class:`~repro_torch.core.ordering.CommQueue`
(``atomic_*_nbi``) wraps ``CommQueue.amo_nbi``: nonblocking fetch-&-op
records drained like signals (``amo_wait`` on the word, or a covering
fence/quiet), each AMO its own linearization point.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve
from . import collectives, safety
from .heap import HeapState, SymHandle
from .ordering import CommQueue, NbiValue, Pairs
from .teams import ActiveSet, Team, TeamAxes


def _per_pe(v, n: int, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(v, device=device)
    if dtype is not None:
        t = t.to(dtype)
    return t.reshape(-1).expand(n) if t.numel() == 1 else t.reshape(n)


def _setup(state, handle, index, value, participate, team, owner,
           active_set, algo):
    """What every owner-computes atomic starts with: membership, the
    gathered (value, participating?) pairs, and the owner's cell."""
    buf = state[handle.name]
    n = buf.shape[0]
    t = Team.of(team, n)
    aset = (active_set or ActiveSet()).resolve(t.size())
    member, vr = collectives._member_mask(t, aset)
    dev = buf.device
    value = _per_pe(value, n, dev)
    part = _per_pe(participate, n, dev, torch.bool) \
        & torch.as_tensor(member, device=dev)
    vals = collectives.fcollect(value, t, algo, aset)          # (n, m)
    masks = collectives.fcollect(part, t, algo, aset).bool()
    flat = buf.reshape(n, -1)
    cell = flat[:, int(index)]
    cell0 = collectives.broadcast(cell, owner, t, "binomial", aset)
    is_owner = torch.as_tensor(member & (vr == owner), device=dev)
    vr_t = torch.as_tensor(vr, device=dev)
    return (buf, flat, t, aset, vr_t, part, vals, masks, cell, cell0,
            is_owner)


def _store(state, handle, buf, flat, index, newcell, is_owner):
    new = flat.clone()
    new[:, int(index)] = torch.where(is_owner, newcell.to(buf.dtype),
                                     flat[:, int(index)])
    out = dict(state)
    out[handle.name] = new.reshape(buf.shape)
    return out


def atomic_fadd(state: HeapState, handle: SymHandle, index, value,
                team: TeamAxes, participate=True, owner: int = 0,
                active_set: Optional[ActiveSet] = None, algo: str = "ring"):
    """``shmem_<type>_fadd`` to cell ``handle[index]`` on PE ``owner``.
    Returns (new_state, each PE's old value): requester i's old value is
    cell + the sum of the participating values before it (an exclusive
    prefix sum, computed on every PE)."""
    with safety.collective_guard(Team.of(team, state[handle.name].shape[0])
                                 .axes, "atomic_fadd"):
        (buf, flat, t, aset, vr, part, vals, masks, cell, cell0,
         is_owner) = _setup(state, handle, index, value, participate, team,
                            owner, active_set, algo)
        contrib = torch.where(masks, vals, torch.zeros_like(vals))
        prefix = torch.cumsum(contrib, 1, dtype=vals.dtype) - contrib
        total = torch.sum(contrib, 1, dtype=vals.dtype)
        ar = torch.arange(vals.shape[0], device=vals.device)
        old_mine = cell0 + prefix[ar, vr]
        out = _store(state, handle, buf, flat, index, cell + total.to(buf.dtype),
                     is_owner)
        return out, torch.where(part, old_mine, torch.zeros_like(old_mine))


def atomic_swap(state: HeapState, handle: SymHandle, index, value,
                team: TeamAxes, participate=True, owner: int = 0,
                active_set: Optional[ActiveSet] = None, algo: str = "ring"):
    """``shmem_swap``: rank-ordered; requester i sees the value written
    by the last participating requester before it (or the original)."""
    with safety.collective_guard(Team.of(team, state[handle.name].shape[0])
                                 .axes, "atomic_swap"):
        (buf, flat, t, aset, vr, part, vals, masks, cell, cell0,
         is_owner) = _setup(state, handle, index, value, participate, team,
                            owner, active_set, algo)
        n, m = vals.shape
        idxs = torch.arange(m, device=vals.device)
        # seq[p, i] = the cell just before requester i acts, on PE p
        earlier = (idxs[None, :] < idxs[:, None])[None] & masks[:, None, :]
        last = torch.where(earlier, idxs, -1).amax(-1)            # (n, m)
        seq = torch.where(last >= 0, torch.gather(vals, 1, last.clamp(min=0)),
                          cell0[:, None].to(vals.dtype))
        ar = torch.arange(n, device=vals.device)
        old_mine = seq[ar, vr]
        last_all = torch.where(masks, idxs, -1).amax(-1)          # (n,)
        final = torch.where(last_all >= 0,
                            vals[ar, last_all.clamp(min=0)],
                            cell0.to(vals.dtype))
        out = _store(state, handle, buf, flat, index, final, is_owner)
        return out, torch.where(part, old_mine, torch.zeros_like(old_mine))


def atomic_cswap(state: HeapState, handle: SymHandle, index, cond, value,
                 team: TeamAxes, participate=True, owner: int = 0,
                 active_set: Optional[ActiveSet] = None, algo: str = "ring"):
    """``shmem_cswap``: rank-ordered compare-and-swap chain; requester i
    succeeds iff the cell (after requesters j < i) equals its ``cond``."""
    with safety.collective_guard(Team.of(team, state[handle.name].shape[0])
                                 .axes, "atomic_cswap"):
        (buf, flat, t, aset, vr, part, vals, masks, cell, cell0,
         is_owner) = _setup(state, handle, index, value, participate, team,
                            owner, active_set, algo)
        n, m = vals.shape
        conds = collectives.fcollect(_per_pe(cond, n, buf.device), t, algo,
                                     aset)
        cur = cell0
        olds = []
        for i in range(m):
            ok = masks[:, i] & (cur == conds[:, i])
            olds.append(cur)
            cur = torch.where(ok, vals[:, i].to(cur.dtype), cur)
        olds = torch.stack(olds, 1)
        ar = torch.arange(n, device=vals.device)
        old_mine = olds[ar, vr]
        out = _store(state, handle, buf, flat, index, cur, is_owner)
        return out, torch.where(part, old_mine, torch.zeros_like(old_mine))


# ======================================================================
# queue-integrated AMOs — nonblocking fetch-&-op on the CommQueue
# ======================================================================
def atomic_fetch_nbi(queue: CommQueue, handle: SymHandle, pairs: Pairs,
                     offset=0) -> NbiValue:
    """``shmem_atomic_fetch_nbi`` — read one symmetric word atomically.
    Readable after ``amo_wait`` on the word (or fence/quiet)."""
    return queue.amo_nbi(handle, "fetch", pairs, offset=offset)  # shmem: deferred-drain


def atomic_fadd_nbi(queue: CommQueue, handle: SymHandle, value,
                    pairs: Pairs, offset=0) -> NbiValue:
    """``shmem_atomic_fetch_add_nbi`` — fetch-&-add on one word."""
    return queue.amo_nbi(handle, "fadd", pairs, value=value,  # shmem: deferred-drain
                         offset=offset)


def atomic_swap_nbi(queue: CommQueue, handle: SymHandle, value,
                    pairs: Pairs, offset=0) -> NbiValue:
    """``shmem_atomic_swap_nbi`` — unconditional fetch-&-write."""
    return queue.amo_nbi(handle, "swap", pairs, value=value,  # shmem: deferred-drain
                         offset=offset)


def atomic_cswap_nbi(queue: CommQueue, handle: SymHandle, cond, value,
                     pairs: Pairs, offset=0) -> NbiValue:
    """``shmem_atomic_compare_swap_nbi`` — write ``value`` iff the word
    equals ``cond``; the fetched pre-op value tells whether it won."""
    return queue.amo_nbi(handle, "cswap", pairs, value=value,  # shmem: deferred-drain
                         cond=cond, offset=offset)


def amo_wait(queue: CommQueue, handle: SymHandle, *, offset=0):
    """The AMO drain point — delivers exactly the pending AMOs on the
    named word (see ``CommQueue.amo_wait``)."""
    return queue.amo_wait(handle, offset=offset)


@dataclasses.dataclass
class TicketLock:
    """API-parity lock (paper §4.6 named mutexes): ``acquire_order``
    gives each PE its ticket (= its turn), the rank-order linearization
    the atomics above implement."""

    team: TeamAxes

    def acquire_order(self, participate=True,
                      active_set: Optional[ActiveSet] = None, device=None):
        """Each PE's ticket, on ``participate``'s device when it is a
        tensor and no ``device`` is given, else on ``device`` (the card
        unless the CPU is asked for)."""
        if device is None and isinstance(participate, torch.Tensor):
            dev = participate.device
        else:
            dev = resolve(device)
        t = Team.of(self.team)
        n = t.size()
        aset = (active_set or ActiveSet()).resolve(n)
        member, vr = collectives._member_mask(t, aset)
        part = _per_pe(participate, n, dev, torch.bool) \
            & torch.as_tensor(member, device=dev)
        masks = collectives.fcollect(part, t, "ring", aset).to(torch.int32)
        # ticket = number of participating PEs with smaller rank
        tickets = torch.cumsum(masks, 1, dtype=torch.int32) - masks
        return tickets[torch.arange(n, device=dev),
                       torch.as_tensor(vr, device=dev)]
