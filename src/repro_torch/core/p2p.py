"""One-sided put/get (paper §3.2, §4.4) on the stacked team (counterpart
of ``repro.core.p2p``).

POSH implements ``put``/``get`` as memory copies into a mapped remote
heap.  The reference expresses each round as a ``ppermute`` with a
static ``(src, dst)`` pair list inside ``shard_map``.  The port holds
every PE's shard in one tensor with the PE axis first, so a round with
pairs ``[(s, d), ...]`` is a copy along that axis::

    out = zeros_like(x);  out[d] = stage(x)[s]   for every pair

A PE that is no destination receives zeros, as in the reference.  The
put/get distinction (who drives the schedule) lives in the callers'
schedules, exactly as in the reference; both are the same data motion.

Every payload of a ``put``/``get`` round passes through the stager
installed by ``staged_payloads`` — the §4.4 memcpy seam, where the
``pallas`` communicator backend puts the CUDA copy engine.  The stager
receives the whole stacked payload ``(n_pe, *shard)`` of the round (one
copy per round); a per-PE payload's bytes are ``x[0]``'s.

Array arguments are stacked tensors ``(n_pe, *shard)``; the team's size
is their leading dimension.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

from . import safety
from .heap import HeapState, SymHandle
from .teams import Team, TeamAxes

Pairs = Sequence[tuple[int, int]]

# ----------------------------------------------------------------------
# payload staging hook — the §4.4 memcpy seam
# ----------------------------------------------------------------------
_stage_state = threading.local()


def _current_stager() -> Optional[Callable]:
    return getattr(_stage_state, "stager", None)


@contextlib.contextmanager
def staged_payloads(stager: Callable[[torch.Tensor], torch.Tensor]):
    """Route every put/get payload inside this scope through ``stager``
    (a value-preserving copy of the stacked payload, e.g. the CUDA
    copy engine).  Nests: the innermost stager wins."""
    prev = _current_stager()
    _stage_state.stager = stager
    try:
        yield
    finally:
        _stage_state.stager = prev


def _stage(x: torch.Tensor) -> torch.Tensor:
    s = _current_stager()
    return x if s is None else s(x.contiguous())


# ----------------------------------------------------------------------
# index tensors: schedules are host data, built once per device
# ----------------------------------------------------------------------
_CONSTS: dict = {}


def const(values, device, dtype=torch.long) -> torch.Tensor:
    """A small constant tensor (index list or per-PE mask) on ``device``,
    made once and reused: a host-to-device copy per round would stall
    the stream."""
    key = (tuple(values), str(device), dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.tensor(list(values), dtype=dtype, device=device)
        _CONSTS[key] = t
    return t


def _check_pairs(pairs: Pairs, n: int, tag: str) -> list[tuple[int, int]]:
    pairs = [(int(s), int(d)) for s, d in pairs]
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"{tag}: sources and destinations must be unique: {pairs}")
    if any(not (0 <= s < n and 0 <= d < n) for s, d in pairs):
        raise ValueError(f"{tag}: pair out of range for team size {n}: {pairs}")
    return pairs


def _permute(x: torch.Tensor, pairs: list[tuple[int, int]]) -> torch.Tensor:
    n = x.shape[0]
    if len(pairs) == n:                   # every PE receives: a gather
        order = [0] * n
        for s, d in pairs:
            order[d] = s
        return x.index_select(0, const(order, x.device))
    out = torch.zeros_like(x)
    out.index_copy_(0, const([d for _, d in pairs], x.device),
                    x.index_select(0, const([s for s, _ in pairs], x.device)))
    return out


def _round(x: torch.Tensor, pairs: Pairs, team: TeamAxes, tag: str):
    t = Team.of(team, x.shape[0])
    safety.check_symmetric_arg(x, tag)
    pairs = _check_pairs(pairs, t.size(), tag)
    if not pairs:
        return torch.zeros_like(x)
    return _permute(_stage(x), pairs)


def put(x: torch.Tensor, pairs: Pairs, team: TeamAxes) -> torch.Tensor:
    """Push each PE's ``x`` along ``pairs``; returns what arrived at each
    PE (zeros where a PE is no destination).  One POSH ``put`` round."""
    return _round(x, pairs, team, "put")


def get(x: torch.Tensor, pairs: Pairs, team: TeamAxes) -> torch.Tensor:
    """Pull: ``pairs`` are (owner, reader); the reader receives the
    owner's ``x``.  The same data motion as ``put``."""
    return _round(x, pairs, team, "get")


def ring_shift(x: torch.Tensor, team: TeamAxes, delta: int = 1
               ) -> torch.Tensor:
    """Uniform shift: PE i's value moves to PE (i+delta) mod n."""
    n = Team.of(team, x.shape[0]).size()
    d = delta % n
    if d == 0:
        return x
    return torch.roll(x, shifts=d, dims=0)


# ----------------------------------------------------------------------
# Heap-addressed one-sided ops (Corollary 1 in action)
# ----------------------------------------------------------------------
def heap_put(state: HeapState, handle: SymHandle, data: torch.Tensor,
             pairs: Pairs, team: TeamAxes, offset=0) -> HeapState:
    """``shmem_put``: write each source's ``data`` rows into the
    destination PE's symmetric object at row ``offset`` — the same
    offset the source would use locally (Corollary 1).  ``data`` is
    stacked ``(n_pe, rows, ...)`` (``(n_pe,)`` for one row).  Returns a
    new state; the given one is left as it was."""
    buf = state[handle.name]
    t = Team.of(team, buf.shape[0])
    incoming = put(data, pairs, t)
    out = dict(state)
    if not pairs:
        out[handle.name] = buf
        return out
    if incoming.dim() == 1:
        incoming = incoming[:, None]
    off, rows = int(offset), incoming.shape[1]
    if not 0 <= off <= off + rows <= buf.shape[1]:
        raise ValueError(f"heap_put[{handle.name}]: rows [{off}, "
                         f"{off + rows}) outside the object's "
                         f"{buf.shape[1]}")
    dst = const([d for _, d in pairs], buf.device)
    new = buf.clone()
    new[dst, off:off + rows] = incoming.index_select(0, dst).to(buf.dtype)
    out[handle.name] = new
    return out


def heap_get(state: HeapState, handle: SymHandle, pairs: Pairs,
             team: TeamAxes, offset=0, size: int | None = None
             ) -> torch.Tensor:
    """``shmem_get``: fetch ``size`` rows at ``offset`` from the owner's
    symmetric object (pairs are (owner, reader)); ``size=None`` reads
    the rest of the object."""
    buf = state[handle.name]
    t = Team.of(team, buf.shape[0])
    off = int(offset)
    if size is None:
        size = buf.shape[1] - off
    if not 0 <= off <= off + size <= buf.shape[1]:
        raise ValueError(f"heap_get[{handle.name}]: rows [{off}, "
                         f"{off + size}) outside the object's "
                         f"{buf.shape[1]}")
    return get(buf[:, off:off + size], pairs, t)


def heap_p(state: HeapState, handle: SymHandle, value, pairs: Pairs,
           team: TeamAxes, index=0) -> HeapState:
    """``shmem_p`` — single-element put; ``value`` is one element per PE
    (or one for all)."""
    buf = state[handle.name]
    v = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
    if v.dim() == 0:
        v = v.expand(buf.shape[0])
    data = v.reshape((buf.shape[0], 1) + tuple(buf.shape[2:]))
    return heap_put(state, handle, data, pairs, team, offset=index)


def heap_g(state: HeapState, handle: SymHandle, pairs: Pairs,
           team: TeamAxes, index=0) -> torch.Tensor:
    """``shmem_g`` — single-element get."""
    return heap_get(state, handle, pairs, team, offset=index, size=1)[:, 0]
