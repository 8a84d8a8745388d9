"""Collective operations built from one-sided put/get rounds (paper §4.5),
on the stacked team (counterpart of ``repro.core.collectives``).

Every collective is composed ONLY of ``p2p`` rounds plus local
combines, the paper's design point, with the algorithm chosen by a
string (POSH's compile-time algorithm switch, §4.5.4):

  barrier_all     dissemination (log n rounds)
  broadcast       binomial (push tree) | binomial_pull | linear | xla
  fcollect        ring | ring_pull | recursive_doubling | xla (allgather)
  reduce          binomial reduce-to-root (building block)
  allreduce       ring (RS+AG) | tree (reduce+bcast) | recursive_doubling
                  | xla
  reduce_scatter  ring | xla
  alltoall        pairwise | xla

Every function takes the stacked ``(n_pe, *shard)`` tensor and returns
``(n_pe, *out_shard)``: exactly the stack of what each PE of the
reference returns inside ``shard_map``.  Each PE combines its chunks in
the reference's order (ring indices ``(vr - s - 2) % n``, recursive
doubling partner ``v ^ shift``, binomial trees rooted and rotated the
same way), so the results are the reference's bit for bit.  Per-PE
quantities the reference traces — rank, virtual rank, membership, the
ring's chunk indices — are host data here (``teams``), turned into index
tensors once (``p2p.const``).

``xla`` is the native baseline, the library role the reference gives
XLA: one PyTorch reduction or reshuffle over the PE axis.  Like the
reference's ``lax`` calls it spans the whole team (``broadcast`` alone
honours the active set).

All collectives accept an OpenSHMEM 1.0 active set; PEs outside it
pass their input through untouched.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve
from . import p2p, safety
from .heap import SymmetricHeap
from .teams import ActiveSet, Team, TeamAxes

_OPS: dict[str, Callable] = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _resolve(team: TeamAxes, n_pe: int, active_set: Optional[ActiveSet]):
    t = Team.of(team, n_pe)
    aset = (active_set or ActiveSet()).resolve(t.size())
    return t, aset


def _member_mask(t: Team, aset: ActiveSet):
    """Per-PE membership and virtual rank (host arrays; vr 0 for
    non-members, as in the reference)."""
    rank = np.arange(t.size())
    stride = 1 << aset.log2_stride
    off = rank - aset.start
    vr = off // stride
    member = (off >= 0) & (off % stride == 0) & (vr < aset.size)
    return member, np.where(member, vr, 0)


def _vpairs(aset: ActiveSet, pairs_v):
    """Map virtual-rank pairs to physical PE pairs (static)."""
    return [(aset.pe(s), aset.pe(d)) for s, d in pairs_v]


def _pe_mask(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    m = p2p.const(mask.tolist(), like.device, torch.bool)
    return m.view((-1,) + (1,) * (like.dim() - 1))


def _masked(member: np.ndarray, new: torch.Tensor, old: torch.Tensor
            ) -> torch.Tensor:
    """Select per PE between the collective's result and ``old``."""
    if member.all():
        return new.reshape(old.shape)
    if not member.any():
        return old
    return torch.where(_pe_mask(member, old), new.reshape(old.shape), old)


def _take(d: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Row ``idx[p]`` of each PE ``p``'s ``d[p]`` (the reference's
    ``dynamic_index_in_dim`` with a per-PE traced index)."""
    ar = p2p.const(range(d.shape[0]), d.device)
    return d[ar, p2p.const(idx.tolist(), d.device)]


def _place(d: torch.Tensor, idx: np.ndarray, val: torch.Tensor) -> None:
    """In place: row ``idx[p]`` of each PE's ``d[p]`` becomes ``val[p]``."""
    ar = p2p.const(range(d.shape[0]), d.device)
    d[ar, p2p.const(idx.tolist(), d.device)] = val.to(d.dtype)


# ======================================================================
# barrier
# ======================================================================
def barrier_all(team: TeamAxes, active_set: Optional[ActiveSet] = None,
                device=None) -> torch.Tensor:
    """Dissemination barrier: log2(n) rounds of token pushes.  ``team``
    must be a Team (or carry its size); returns each PE's token count
    (2^ceil(log2 n) for every member), on ``device`` (the card unless
    the CPU is asked for)."""
    t = Team.of(team)
    aset = (active_set or ActiveSet()).resolve(t.size())
    n = aset.size
    with safety.collective_guard(t.axes, "barrier_all"):
        tok = torch.ones((t.size(),), dtype=torch.int32,
                         device=resolve(device))
        if n == 1:
            return tok
        for k in range(math.ceil(math.log2(n))):
            shift = 1 << k
            pairs = _vpairs(aset, [(v, (v + shift) % n) for v in range(n)])
            recv = p2p.put(tok, pairs, t)
            tok = tok + recv
        return tok


# ======================================================================
# broadcast (shmem_broadcast, §4.5)
# ======================================================================
def broadcast(x: torch.Tensor, root: int, team: TeamAxes,
              algo: str = "binomial",
              active_set: Optional[ActiveSet] = None) -> torch.Tensor:
    """Root's value delivered to every member PE.  ``root`` is a virtual
    rank in the active set."""
    t, aset = _resolve(team, x.shape[0], active_set)
    n = aset.size
    if not (0 <= root < n):
        raise ValueError(f"broadcast root {root} out of range for set size {n}")
    safety.check_symmetric_arg(x, "broadcast")
    with safety.collective_guard(t.axes, f"broadcast[{algo}]"):
        if n == 1:
            return x
        if algo == "xla":
            member, _ = _member_mask(t, aset)
            out = x[aset.pe(root)].expand_as(x)
            return _masked(member, out, x).contiguous()
        if algo in ("binomial", "binomial_pull"):
            return _bcast_binomial(x, root, t, aset, pull=algo.endswith("pull"))
        if algo == "linear":
            return _bcast_linear(x, root, t, aset)
        raise ValueError(f"unknown broadcast algo '{algo}'")


def _bcast_binomial(x, root, t: Team, aset: ActiveSet, pull: bool):
    """Binomial tree: round k doubles the informed set.  Push and pull
    build the same pair set; pull is receiver-driven."""
    n = aset.size
    member, vr = _member_mask(t, aset)
    vrel = (vr - root) % n
    out = x
    for k in range(math.ceil(math.log2(n))):
        shift = 1 << k
        if pull:
            pv = [((v - shift + root) % n, (v + root) % n)
                  for v in range(shift, min(2 * shift, n))]
        else:
            pv = [((v + root) % n, (v + shift + root) % n)
                  for v in range(shift) if v + shift < n]
        incoming = p2p.get(out, _vpairs(aset, pv), t) if pull \
            else p2p.put(out, _vpairs(aset, pv), t)
        got_now = member & (vrel >= shift) & (vrel < 2 * shift)
        out = _masked(got_now, incoming.to(out.dtype), out)
    return _masked(member, out, x)


def _bcast_linear(x, root, t: Team, aset: ActiveSet):
    """Flat put-based broadcast: root pushes to one PE per round (n-1
    rounds) — deliberately latency-poor, for the §4.5.4 comparison."""
    n = aset.size
    member, vr = _member_mask(t, aset)
    vrel = (vr - root) % n
    out = x
    for s in range(1, n):
        pv = [(root, (root + s) % n)]
        incoming = p2p.put(out, _vpairs(aset, pv), t)
        out = _masked(member & (vrel == s), incoming.to(out.dtype), out)
    return _masked(member, out, x)


# ======================================================================
# fcollect (allgather, §4.5)
# ======================================================================
def fcollect(x: torch.Tensor, team: TeamAxes, algo: str = "ring",
             active_set: Optional[ActiveSet] = None) -> torch.Tensor:
    """Concatenate every member's shard along a new axis: ``(n_pe,
    *shard)`` -> ``(n_pe, n_set, *shard)``.  Non-members receive zeros in
    foreign slots."""
    t, aset = _resolve(team, x.shape[0], active_set)
    n = aset.size
    safety.check_symmetric_arg(x, "fcollect")
    with safety.collective_guard(t.axes, f"fcollect[{algo}]"):
        if n == 1:
            return x[:, None]
        if algo == "xla":
            return x.unsqueeze(0).expand((x.shape[0],) + x.shape).contiguous()
        if algo in ("ring", "ring_pull"):
            return _fcollect_ring(x, t, aset, pull=algo.endswith("pull"))
        if algo == "recursive_doubling":
            if n & (n - 1):
                # non-power-of-two: documented fallback
                return _fcollect_ring(x, t, aset, pull=False)
            return _fcollect_rd(x, t, aset)
        raise ValueError(f"unknown fcollect algo '{algo}'")


def _fcollect_ring(x, t: Team, aset: ActiveSet, pull: bool):
    """Ring allgather: n-1 rounds, each PE forwarding the chunk it
    received last round (push +1; pull -1, reader-driven)."""
    n = aset.size
    member, vr = _member_mask(t, aset)
    out = x.new_zeros((x.shape[0], n) + x.shape[1:])
    _place(out, vr, x)
    cur = x
    step_dir = 1 if not pull else -1
    for s in range(1, n):
        if pull:
            pv = [((v + 1) % n, v) for v in range(n)]   # reader v pulls v+1
        else:
            pv = [(v, (v + 1) % n) for v in range(n)]   # owner v pushes v+1
        cur = (p2p.get if pull else p2p.put)(cur, _vpairs(aset, pv), t)
        _place(out, (vr - s * step_dir) % n, cur)
    if member.all():
        return out
    return _masked(member, out, x.unsqueeze(1).expand_as(out) * 0 + out)


def _fcollect_rd(x, t: Team, aset: ActiveSet):
    """Recursive doubling (power-of-two n): log2 n doubling exchanges,
    the buffer ordered by virtual-rank low bits."""
    n = aset.size
    member, vr = _member_mask(t, aset)
    buf = x[:, None]
    for k in range(int(math.log2(n))):
        shift = 1 << k
        pv = [(v, v ^ shift) for v in range(n)]
        recv = p2p.put(buf, _vpairs(aset, pv), t)
        bit = (vr >> k) & 1
        lo = torch.cat([buf, recv], dim=1)
        hi = torch.cat([recv, buf], dim=1)
        buf = _masked(bit == 0, lo, hi)
    if member.all():
        return buf
    return _masked(member, buf, torch.zeros_like(buf) + buf)


# ======================================================================
# reductions (§4.5: shmem_<op>_to_all)
# ======================================================================
def reduce(x: torch.Tensor, root: int, op: str, team: TeamAxes,
           active_set: Optional[ActiveSet] = None) -> torch.Tensor:
    """Binomial reduce-to-root (building block for 'tree' allreduce)."""
    t, aset = _resolve(team, x.shape[0], active_set)
    n = aset.size
    combine = _OPS[op]
    with safety.collective_guard(t.axes, f"reduce[{op}]"):
        if n == 1:
            return x
        member, vr = _member_mask(t, aset)
        vrel = (vr - root) % n
        acc = x
        for k in range(math.ceil(math.log2(n))):
            shift = 1 << k
            # senders: vrel with bit k set and lower bits clear
            pv = [((v + root) % n, (v - shift + root) % n)
                  for v in range(shift, n, 2 * shift)]
            incoming = p2p.put(acc, _vpairs(aset, pv), t)
            receives = member & (vrel % (2 * shift) == 0) & (vrel + shift < n)
            acc = _masked(receives, combine(acc, incoming.to(acc.dtype)), acc)
        return _masked(member & (vrel == 0), acc, x)


def allreduce(x: torch.Tensor, op: str = "sum", team: TeamAxes = "data",
              algo: str = "ring", active_set: Optional[ActiveSet] = None,
              heap: Optional[SymmetricHeap] = None) -> torch.Tensor:
    """All-members reduction.  ``algo``: ring (reduce-scatter + allgather
    rings, bandwidth-optimal), tree (binomial reduce + broadcast,
    latency-optimal), recursive_doubling (power-of-two sets, ring
    otherwise), xla (one PyTorch reduction over the PE axis)."""
    t, aset = _resolve(team, x.shape[0], active_set)
    n = aset.size
    if op not in _OPS:
        raise ValueError(f"unknown reduce op '{op}'")
    safety.check_symmetric_arg(x, "allreduce")
    with safety.collective_guard(t.axes, f"allreduce[{algo},{op}]"):
        if n == 1:
            return x
        if algo == "xla":
            if op == "sum":
                r = torch.sum(x, 0, keepdim=True, dtype=x.dtype)
            elif op == "prod":
                r = torch.prod(x, 0, keepdim=True, dtype=x.dtype)
            elif op == "max":
                r = torch.amax(x, 0, keepdim=True)
            else:
                r = torch.amin(x, 0, keepdim=True)
            return r.expand_as(x).contiguous()
        if algo == "tree":
            r = reduce(x, 0, op, t, aset)
            return broadcast(r, 0, t, "binomial", aset)
        if algo == "recursive_doubling":
            if n & (n - 1):
                return _allreduce_ring(x, op, t, aset, heap)
            return _allreduce_rd(x, op, t, aset)
        if algo == "ring":
            return _allreduce_ring(x, op, t, aset, heap)
        raise ValueError(f"unknown allreduce algo '{algo}'")


def _pad_chunks(x, n):
    """Each PE's shard flattened, zero-padded and cut into n chunks:
    ``(n_pe, n, c)`` — a new tensor the ring may update in place."""
    flat = x.reshape(x.shape[0], -1)
    size = flat.shape[1]
    c = -(-size // n)
    data = flat.new_zeros((x.shape[0], n * c))
    data[:, :size] = flat
    return data.view(x.shape[0], n, c), c


def _allreduce_rd(x, op, t: Team, aset: ActiveSet):
    n = aset.size
    member, _ = _member_mask(t, aset)
    combine = _OPS[op]
    acc = x
    for k in range(int(math.log2(n))):
        shift = 1 << k
        pv = [(v, v ^ shift) for v in range(n)]
        recv = p2p.put(acc, _vpairs(aset, pv), t)
        acc = combine(acc, recv.to(acc.dtype))
    return _masked(member, acc, x)


def _ring_reduce_scatter(d, combine, t: Team, aset: ActiveSet, vr):
    """n-1 rounds; afterwards PE v owns the reduced chunk v of ``d``
    (``(n_pe, n, ...)``, updated in place)."""
    n = aset.size
    pairs = _vpairs(aset, [(v, (v + 1) % n) for v in range(n)])
    for s in range(n - 1):
        recv = p2p.put(_take(d, (vr - s - 1) % n), pairs, t)
        acc_idx = (vr - s - 2) % n
        cur = _take(d, acc_idx)
        _place(d, acc_idx, combine(cur, recv.to(cur.dtype)))


def _allreduce_ring(x, op, t: Team, aset: ActiveSet,
                    heap: Optional[SymmetricHeap]):
    """Ring reduce-scatter then ring allgather, both of put rounds.  With
    a heap, the chunk buffer is a Lemma-1 temporary symmetric
    allocation, released before the collective returns."""
    n = aset.size
    member, vr = _member_mask(t, aset)
    combine = _OPS[op]
    data, c = _pad_chunks(x, n)

    def body(d):
        _ring_reduce_scatter(d, combine, t, aset, vr)
        # allgather phase: circulate the owned chunk
        pairs = _vpairs(aset, [(v, (v + 1) % n) for v in range(n)])
        for s in range(n - 1):
            recv = p2p.put(_take(d, (vr - s) % n), pairs, t)
            _place(d, (vr - s - 1) % n, recv)
        return d

    if heap is not None:
        with heap.scratch((n, c), x.dtype, tag="ring_allreduce"):
            data = body(data)
    else:
        data = body(data)
    size = x[0].numel()
    out = data.reshape(x.shape[0], -1)[:, :size].reshape(x.shape)
    return _masked(member, out, x)


def reduce_scatter(x: torch.Tensor, op: str = "sum", team: TeamAxes = "data",
                   algo: str = "ring",
                   active_set: Optional[ActiveSet] = None) -> torch.Tensor:
    """PE v receives chunk v of the reduction; each shard is split along
    its first axis into n equal chunks."""
    t, aset = _resolve(team, x.shape[0], active_set)
    n = aset.size
    if x.shape[1] % n:
        raise ValueError(f"reduce_scatter axis0 {x.shape[1]} not divisible by {n}")
    with safety.collective_guard(t.axes, f"reduce_scatter[{algo},{op}]"):
        if n == 1:
            return x
        if algo == "xla":
            if op != "sum":
                raise ValueError("xla reduce_scatter supports sum only")
            n_pe = x.shape[0]
            return torch.sum(x.reshape((n_pe, n_pe, x.shape[1] // n_pe)
                                       + x.shape[2:]), 0, dtype=x.dtype)
        if algo != "ring":
            raise ValueError(f"unknown reduce_scatter algo '{algo}'")
        member, vr = _member_mask(t, aset)
        k = x.shape[1] // n
        d = x.reshape((x.shape[0], n, k) + x.shape[2:]).clone()
        _ring_reduce_scatter(d, _OPS[op], t, aset, vr)
        return _masked(member, _take(d, vr), x[:, :k])


# ======================================================================
# alltoall (§4.5)
# ======================================================================
def alltoall(x: torch.Tensor, team: TeamAxes = "model", algo: str = "pairwise",
             active_set: Optional[ActiveSet] = None) -> torch.Tensor:
    """Each shard has shape (n, ...): slot j goes to PE j; output slot j
    holds what PE j sent here.  ``pairwise``: n-1 rounds of disjoint
    pair exchanges built from puts."""
    t, aset = _resolve(team, x.shape[0], active_set)
    n = aset.size
    if x.shape[1] != n:
        raise ValueError(f"alltoall leading dim {x.shape[1]} != set size {n}")
    with safety.collective_guard(t.axes, f"alltoall[{algo}]"):
        if n == 1:
            return x
        if algo == "xla":
            return x.transpose(0, 1).contiguous()
        if algo != "pairwise":
            raise ValueError(f"unknown alltoall algo '{algo}'")
        member, vr = _member_mask(t, aset)
        out = torch.zeros_like(x)
        _place(out, vr, _take(x, vr))
        for s in range(1, n):
            payload = _take(x, (vr + s) % n)
            pv = [(v, (v + s) % n) for v in range(n)]
            recv = p2p.put(payload, _vpairs(aset, pv), t)
            _place(out, (vr - s) % n, recv)
        return _masked(member, out, x)
