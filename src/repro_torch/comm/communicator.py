"""First-class communicators: team-bound collective objects with
size-aware algorithm dispatch and per-op instrumentation (counterpart of
``repro.comm.communicator``).

A ``Communicator`` binds a *team* (the PEs of one stacked tensor axis),
a *backend* (how collectives are realized) and a *dispatch table* (which
algorithm each call uses, chosen from the per-PE payload bytes and the
team size — the paper's tuned selection, §4.5.4).  Every call records
what it did, readable back as a plain dict.

Backends come from a registry::

    register_backend("my_backend", MyBackendClass)
    comm = Communicator("pe", size=8, backend="my_backend")

Three ship with the port, under the reference's names:

    "xla"    the native baseline: one PyTorch reduction or reshuffle
             over the PE axis.  Dispatch always resolves to "xla".
    "posh"   the paper's put/get schedules (``core.collectives``), the
             algorithm chosen per call by the dispatch table.
    "pallas" the posh schedules with the CUDA copy engine
             (``kernels.symm_copy``) staging every payload of every round
             (``comm.pallas_backend``, registered on package import).

Arguments and results are stacked, ``(n_pe, *shard)`` with ``n_pe ==
size``; axis arguments name the shard's axes, as in the reference.
Instrumentation counts eager calls (the reference counts traced ones:
one call here is one traced call there).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Type

import torch

from ..core import collectives as posh
from ..core.heap import SymmetricHeap
from ..core.teams import Team, TeamAxes

# ======================================================================
# dispatch table — (op, payload bytes, team size) -> algorithm
# ======================================================================

# Default size thresholds, the reference's: the paper's bandwidth-model
# crossover (§4.5.4: ring wins once the 2(n-1)/n·B wire term dominates
# the per-round latency).  ``DispatchTable.tuned_from_bench`` takes the
# crossovers measured by ``repro_torch.launch.comm_bench`` instead.
_ALLREDUCE_SMALL_BYTES = 16 << 10     # <= 16 KiB/PE -> eager (tree/rd)
_ALLGATHER_SMALL_BYTES = 32 << 10     # <= 32 KiB/PE -> recursive doubling


@dataclasses.dataclass(frozen=True)
class DispatchTable:
    """Maps (op, per-PE payload nbytes, team size) to a schedule name.

    Two regimes per sized op, the paper's §4.5.4 split: *eager*
    (latency-optimal, O(log n) rounds of full payloads: binomial tree /
    recursive doubling) at or below the op's threshold, *chunked*
    (bandwidth-optimal rings moving 1/n-size chunks) above it.
    ``small_team_max`` short-circuits to eager for tiny teams.
    """

    allreduce_small_bytes: int = _ALLREDUCE_SMALL_BYTES
    allgather_small_bytes: int = _ALLGATHER_SMALL_BYTES
    small_team_max: int = 2
    allreduce_eager: str = "tree"
    allreduce_chunked: str = "ring"
    allgather_eager: str = "recursive_doubling"
    allgather_chunked: str = "ring"
    reducescatter_algo: str = "ring"
    alltoall_algo: str = "pairwise"
    broadcast_algo: str = "binomial"

    def choose(self, op: str, nbytes: int, team_size: int) -> str:
        """Schedule for one call."""
        pow2 = team_size & (team_size - 1) == 0
        if op in ("psum", "pmax"):
            eager = (team_size <= self.small_team_max
                     or nbytes <= self.allreduce_small_bytes)
            algo = self.allreduce_eager if eager else self.allreduce_chunked
            if algo == "recursive_doubling" and not pow2:
                # rd needs a power-of-two team; fall back to the chunked
                # ring like core.collectives itself does
                algo = self.allreduce_chunked
                if algo == "recursive_doubling":   # chunked pinned to rd
                    algo = "ring"
            return algo
        if op == "all_gather":
            eager = (team_size <= self.small_team_max
                     or nbytes <= self.allgather_small_bytes)
            algo = self.allgather_eager if eager else self.allgather_chunked
            if algo == "recursive_doubling" and not pow2:
                algo = self.allgather_chunked
                if algo == "recursive_doubling":
                    algo = "ring"
            return algo
        if op == "psum_scatter":
            return self.reducescatter_algo
        if op == "all_to_all":
            return self.alltoall_algo
        if op == "pbroadcast":
            return self.broadcast_algo
        if op == "top_k_merge":
            # candidate merge = an all_gather + a replicated local sort
            return self.choose("all_gather", nbytes, team_size)
        raise KeyError(f"no dispatch rule for op '{op}'")

    @classmethod
    def fixed(cls, allreduce: str = "ring", allgather: str = "ring",
              reducescatter: str = "ring", alltoall: str = "pairwise",
              broadcast: str = "binomial") -> "DispatchTable":
        """A table pinned to one algorithm per op regardless of size."""
        return cls(allreduce_eager=allreduce, allreduce_chunked=allreduce,
                   allgather_eager=allgather, allgather_chunked=allgather,
                   reducescatter_algo=reducescatter, alltoall_algo=alltoall,
                   broadcast_algo=broadcast)

    @classmethod
    def tuned_from_bench(cls, bench: dict) -> "DispatchTable":
        """Thresholds at the measured eager/chunked crossover of a bench
        dict (``BENCH_comm.json``'s row schema): the largest measured
        size at which the eager schedule still wins, 0 if it never wins,
        the default when no size has both algorithms."""
        def crossover(op, eager, chunked, default):
            rows = [r for r in bench.get("results", [])
                    if r["op"] == op and r["algo"] in (eager, chunked)]
            by_size: dict[int, dict[str, float]] = {}
            for r in rows:
                by_size.setdefault(r["nbytes"], {})[r["algo"]] = r["us_per_call"]
            measured = [nb for nb, t in by_size.items()
                        if eager in t and chunked in t]
            if not measured:
                return default
            best = 0                       # eager never wins -> all chunked
            for nb in sorted(measured):
                t = by_size[nb]
                if t[eager] <= t[chunked]:
                    best = nb              # largest size where eager wins
            return best
        return cls(
            allreduce_small_bytes=crossover(
                "psum", "tree", "ring", _ALLREDUCE_SMALL_BYTES),
            allgather_small_bytes=crossover(
                "all_gather", "recursive_doubling", "ring",
                _ALLGATHER_SMALL_BYTES))


# ======================================================================
# backend registry
# ======================================================================
def _ax(axis: int, ndim: int) -> int:
    """A shard axis -> the stacked tensor's axis (negative axes count
    from the shard's end)."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for a {ndim}-d shard")
    return axis % ndim + 1


class CommBackend:
    """Interface a communicator backend implements.  Arguments are
    stacked ``(n_pe, *shard)`` tensors; ``team`` is a ``core.Team``;
    ``algo`` is the dispatch table's choice.  Semantics are the
    reference's (``lax`` collective semantics per PE)."""

    name: str = "?"

    def select(self, op: str, nbytes: int, team_size: int,
               table: DispatchTable) -> str:
        return table.choose(op, nbytes, team_size)

    def psum(self, x, team: Team, algo: str, heap=None):
        raise NotImplementedError

    def pmax(self, x, team: Team, algo: str):
        raise NotImplementedError

    def all_gather(self, x, team: Team, algo: str, *, gather_axis: int,
                   tiled: bool):
        raise NotImplementedError

    def psum_scatter(self, x, team: Team, algo: str, *, scatter_axis: int):
        raise NotImplementedError

    def all_to_all(self, x, team: Team, algo: str, *, split_axis: int,
                   concat_axis: int, team_size: int):
        raise NotImplementedError

    def pbroadcast(self, x, root: int, team: Team, algo: str):
        raise NotImplementedError


class XlaBackend(CommBackend):
    """The native baseline — one PyTorch reduction or reshuffle over the
    PE axis (the §5.3 'vendor library' role the reference gives XLA)."""

    name = "xla"

    def select(self, op, nbytes, team_size, table):
        return "xla"

    def psum(self, x, team, algo, heap=None):
        return posh.allreduce(x, "sum", team, "xla")

    def pmax(self, x, team, algo):
        return posh.allreduce(x, "max", team, "xla")

    def all_gather(self, x, team, algo, *, gather_axis, tiled):
        a = _ax(gather_axis, x.dim() - 1 + (0 if tiled else 1))
        g = torch.cat(list(x), dim=a - 1) if tiled \
            else torch.stack(list(x), dim=a - 1)
        return g.unsqueeze(0).expand((x.shape[0],) + g.shape).contiguous()

    def psum_scatter(self, x, team, algo, *, scatter_axis):
        a = _ax(scatter_axis, x.dim() - 1)
        s = torch.sum(x, 0, dtype=x.dtype)
        return torch.stack(s.chunk(x.shape[0], dim=a - 1))

    def all_to_all(self, x, team, algo, *, split_axis, concat_axis,
                   team_size):
        n = team_size
        a, c = _ax(split_axis, x.dim() - 1), _ax(concat_axis, x.dim() - 1)
        # (src, ..., blk, L/n, ...) -> (blk, src, ...): blk is the
        # destination; then each destination concatenates its sources'
        # blocks along the concat axis, source-major
        xs = x.reshape(x.shape[:a] + (n, x.shape[a] // n) + x.shape[a + 1:])
        xs = xs.movedim(a, 0).movedim(1, c)
        shape = list(xs.shape)
        shape[c:c + 2] = [shape[c] * shape[c + 1]]
        return xs.reshape(shape)

    def pbroadcast(self, x, root, team, algo):
        return posh.broadcast(x, root, team, "xla")


class PoshBackend(CommBackend):
    """The paper's put/get schedules (``core.collectives``)."""

    name = "posh"

    def psum(self, x, team, algo, heap=None):
        return posh.allreduce(x, "sum", team, algo, heap=heap)

    def pmax(self, x, team, algo):
        return posh.allreduce(x, "max", team, algo)

    def all_gather(self, x, team, algo, *, gather_axis, tiled):
        if not tiled:
            out = posh.fcollect(x, team, algo)          # (n_pe, n, *shard)
            return out.movedim(1, _ax(gather_axis, x.dim()))
        a = _ax(gather_axis, x.dim() - 1)
        moved = x.movedim(a, 1)
        out = posh.fcollect(moved, team, algo)
        out = out.reshape((x.shape[0], -1) + moved.shape[2:])
        return out.movedim(1, a)

    def psum_scatter(self, x, team, algo, *, scatter_axis):
        a = _ax(scatter_axis, x.dim() - 1)
        out = posh.reduce_scatter(x.movedim(a, 1), "sum", team, algo)
        return out.movedim(1, a)

    def all_to_all(self, x, team, algo, *, split_axis, concat_axis,
                   team_size):
        n = team_size
        a, c = _ax(split_axis, x.dim() - 1), _ax(concat_axis, x.dim() - 1)
        moved = x.movedim(a, 1)
        blocks = moved.reshape((x.shape[0], n, moved.shape[1] // n)
                               + moved.shape[2:])
        recv = posh.alltoall(blocks, team, algo)
        parts = [recv[:, j].movedim(1, a) for j in range(n)]
        return torch.cat(parts, dim=c)

    def pbroadcast(self, x, root, team, algo):
        return posh.broadcast(x, root, team, algo)


_REGISTRY: Dict[str, Type[CommBackend]] = {}


def register_backend(name: str, backend_cls: Type[CommBackend], *,
                     overwrite: bool = False) -> None:
    """Register a communicator backend class under ``name``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"comm backend '{name}' already registered")
    _REGISTRY[name] = backend_cls


def get_backend(name: str) -> CommBackend:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown comm backend '{name}' "
            f"(registered: {sorted(_REGISTRY)})") from None


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


register_backend("xla", XlaBackend)
register_backend("posh", PoshBackend)


# ======================================================================
# the communicator
# ======================================================================
def _nbytes(x: torch.Tensor) -> int:
    """One PE's payload bytes (the shard ``x[0]``): what the reference's
    dispatch reads inside ``shard_map``."""
    return x[0].numel() * x.element_size()


def merge_candidates(vals, idxs, k: int):
    """Merge ``(value, global-index)`` candidate lists along the last
    axis into the top ``k`` by value descending, ties broken toward the
    LOWEST global index (two stable sorts: index ascending, then value
    descending)."""
    k = min(int(k), vals.shape[-1])
    o0 = torch.argsort(idxs, dim=-1, stable=True)
    v = torch.take_along_dim(vals, o0, dim=-1)
    i = torch.take_along_dim(idxs, o0, dim=-1)
    o1 = torch.argsort(-v, dim=-1, stable=True)
    return (torch.take_along_dim(v, o1, dim=-1)[..., :k],
            torch.take_along_dim(i, o1, dim=-1)[..., :k])


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _is_single(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


class Communicator:
    """A team-bound collective endpoint.

    Method semantics are the reference's per PE:

        psum(x) / pmax(x)                 full allreduce over the team
        pmean(x)                          psum / team size
        all_gather(x, axis=0, tiled)      tiled concatenates along
                                          ``axis``; tiled=False inserts a
                                          new stacked axis at ``axis``
        psum_scatter(x, axis=0)           reduce + scatter chunks of axis
        all_to_all(x, split_axis, concat_axis)
        pbroadcast(x, root)               root's value to all members
        top_k_merge(vals, idxs, k)        global top-k of candidate lists
        rank() / size                     every PE's rank / team size

    ``x`` is stacked ``(size, *shard)``.  A team of one PE short-circuits
    every op to the identity (recorded under "identity").
    """

    def __init__(self, team: TeamAxes, *, size: int, backend: str = "xla",
                 dispatch: Optional[DispatchTable] = None,
                 heap: Optional[SymmetricHeap] = None,
                 name: Optional[str] = None):
        self.size = int(size)
        if self.size < 1:
            raise ValueError(f"communicator team size must be ≥1, got {size}")
        self.team = Team.of(team, self.size)
        self.backend_name = backend
        self.backend = get_backend(backend)
        self.dispatch = dispatch or DispatchTable()
        self.heap = heap
        self.name = name or f"{backend}:{'x'.join(self.team.axes)}"
        self._stats: dict = {}

    def _key(self):
        return (self.backend_name, self.team, self.size, self.dispatch,
                id(self.heap) if self.heap is not None else None)

    def __eq__(self, other):
        return isinstance(other, Communicator) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Communicator({self.name!r}, axes={self.team.axes}, "
                f"size={self.size}, backend={self.backend_name!r})")

    # -- instrumentation ----------------------------------------------
    def _record(self, op: str, nbytes: int, algo: str) -> None:
        s = self._stats.setdefault(
            op, {"calls": 0, "bytes": 0, "algos": {}})
        s["calls"] += 1
        s["bytes"] += nbytes
        s["algos"][algo] = s["algos"].get(algo, 0) + 1

    def stats(self) -> dict:
        """``{op: {"calls": int, "bytes": int, "algos": {algo: count}}}``;
        bytes are per-PE payload bytes."""
        return copy.deepcopy(self._stats)

    def reset_stats(self) -> None:
        self._stats.clear()

    def _begin(self, op: str, x: torch.Tensor) -> Optional[str]:
        """Dispatch + record; None for the 1-PE identity short-circuit."""
        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"{op}: expected a stacked ({self.size}, ...) "
                             f"tensor, got shape {tuple(x.shape)}")
        nbytes = _nbytes(x)
        if self.size == 1:
            self._record(op, nbytes, "identity")
            return None
        algo = self.backend.select(op, nbytes, self.size, self.dispatch)
        self._record(op, nbytes, algo)
        return algo

    # -- collectives ---------------------------------------------------
    def psum(self, x):
        if not _is_single(x):
            return _tree_map(self.psum, x)
        algo = self._begin("psum", x)
        if algo is None:
            return x
        return self.backend.psum(x, self.team, algo, heap=self.heap)

    def pmax(self, x):
        if not _is_single(x):
            return _tree_map(self.pmax, x)
        algo = self._begin("pmax", x)
        if algo is None:
            return x
        return self.backend.pmax(x, self.team, algo)

    def pmean(self, x):
        out = self.psum(x)
        if self.size == 1:
            return out
        return _tree_map(lambda t: t / self.size, out)

    def all_gather(self, x, axis: int = 0, *, tiled: bool = True):
        if not _is_single(x):
            return _tree_map(lambda t: self.all_gather(t, axis, tiled=tiled), x)
        algo = self._begin("all_gather", x)
        if algo is None:
            return x if tiled else x.unsqueeze(_ax(axis, x.dim()))
        return self.backend.all_gather(x, self.team, algo,
                                       gather_axis=axis, tiled=tiled)

    def psum_scatter(self, x, axis: int = 0):
        if not _is_single(x):
            return _tree_map(lambda t: self.psum_scatter(t, axis), x)
        length = x.shape[_ax(axis, x.dim() - 1)]
        if length % self.size:
            raise ValueError(
                f"psum_scatter axis {axis} (len {length}) not divisible by "
                f"team size {self.size}")
        algo = self._begin("psum_scatter", x)
        if algo is None:
            return x
        return self.backend.psum_scatter(x, self.team, algo,
                                         scatter_axis=axis)

    def all_to_all(self, x, *, split_axis: int, concat_axis: int):
        if not _is_single(x):
            return _tree_map(
                lambda t: self.all_to_all(t, split_axis=split_axis,
                                          concat_axis=concat_axis), x)
        length = x.shape[_ax(split_axis, x.dim() - 1)]
        if length % self.size:
            raise ValueError(
                f"all_to_all split axis {split_axis} (len {length}) not "
                f"divisible by team size {self.size}")
        algo = self._begin("all_to_all", x)
        if algo is None:
            return x
        return self.backend.all_to_all(x, self.team, algo,
                                       split_axis=split_axis,
                                       concat_axis=concat_axis,
                                       team_size=self.size)

    def top_k_merge(self, vals, idxs, k: int):
        """Merge each rank's ``(value, global-index)`` candidate lists
        (``(size, ..., k_loc)``, values descending per rank) into the
        global top ``k`` on every rank.  The payload moves as ONE
        all_gather: f32 values and bitcast int32 indices packed into one
        ``(..., 2k)`` tensor; the merge is a replicated local sort with
        the lowest-global-index tie-break.  Values come back as
        float32."""
        k = int(k)
        kk = vals.shape[-1]
        packed = torch.cat([vals.to(torch.float32),
                            idxs.to(torch.int32).view(torch.float32)], dim=-1)
        algo = self._begin("top_k_merge", packed)
        if algo is None:
            return vals[..., :k], idxs[..., :k]
        # (size, n, ..., 2kk) stacked rank-major, then (..., n*kk) per list
        g = self.backend.all_gather(packed, self.team, algo,
                                    gather_axis=0, tiled=False)
        g = g.movedim(1, -2)                           # (size, ..., n, 2kk)
        flat = vals.shape[:-1] + (self.size * kk,)
        gv = g[..., :kk].reshape(flat)
        gi = g[..., kk:].contiguous().view(torch.int32).reshape(flat)
        return merge_candidates(gv, gi, k)

    def pbroadcast(self, x, root: int = 0):
        if not _is_single(x):
            return _tree_map(lambda t: self.pbroadcast(t, root), x)
        if not (0 <= root < self.size):
            raise ValueError(f"broadcast root {root} out of range "
                             f"for team of {self.size}")
        algo = self._begin("pbroadcast", x)
        if algo is None:
            return x
        return self.backend.pbroadcast(x, root, self.team, algo)

    # -- ordered nonblocking pipeline ----------------------------------
    def queue(self, state=None, *, delivery_seed=None, transport=None):
        """A :class:`core.CommQueue` bound to this communicator's team:
        ``put_nbi``/``get_nbi``/``allreduce_nbi`` enqueue,
        ``fence``/``quiet`` drain.  Pass the heap ``state`` explicitly."""
        from ..core.ordering import CommQueue
        return CommQueue(self.team, state, transport=transport,
                         delivery_seed=delivery_seed)

    # -- topology ------------------------------------------------------
    def rank(self, device=None) -> torch.Tensor:
        """Every PE's rank in the flattened team, along the PE axis, on
        ``device`` (the card unless the CPU is asked for)."""
        return self.team.my_pe(device)

    @property
    def axis_name(self):
        return self.team.axis_name

    # -- tree-level reductions: the training slice of the port --------
    def tree_psum(self, tree):
        raise NotImplementedError("tree_psum arrives with the training "
                                  "slice of the port")

    def tree_pmean(self, tree):
        raise NotImplementedError("tree_pmean arrives with the training "
                                  "slice of the port")

    def bucketed_psum(self, tree, *, bucket_bytes: int = 4 << 20, heap=None):
        raise NotImplementedError("bucketed_psum (comm.bucketing) arrives "
                                  "with the training slice of the port")

    def compressed_psum(self, tree, *, scheme: str = "bf16", state=None,
                        mean: bool = True):
        raise NotImplementedError("compressed_psum (comm.compress) arrives "
                                  "with the training slice of the port")


def make_communicator(team: TeamAxes, *, size: Optional[int] = None,
                      backend: str = "xla",
                      dispatch: Optional[DispatchTable] = None,
                      heap: Optional[SymmetricHeap] = None,
                      name: Optional[str] = None) -> Communicator:
    """Build a communicator for a team of ``size`` PEs (a Team carries
    its own size)."""
    if size is None:
        if not isinstance(team, Team):
            raise ValueError("make_communicator: give size= or a Team")
        size = team.size()
    return Communicator(team, size=size, backend=backend, dispatch=dispatch,
                        heap=heap, name=name)
