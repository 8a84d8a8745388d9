"""The symmetric heap allocator (POSH paper §3.1, §4.1).

The counterpart of ``repro.core.heap``.  POSH's central object is the
per-PE *symmetric heap*: every allocation is collective, so any object
lives at the **same offset on every PE** (Fact 1) and a remote address
is ``heap_remote + (addr_local - heap_local)`` (Corollary 1).  What is
kept here is the allocator — a linear symmetric address space with
first-fit allocation, alignment (``shmemalign``), coalescing free,
``shrealloc`` and offset-based address resolution — which is host-side
Python and gives the same offsets as the reference for the same
allocation sequence.

Heap *state* — the tensors — is a plain dict ``name -> tensor`` with the
team's PE axis first, ``(n_pe, *shape)``: every PE's copy of every
symmetric object on one device (``zeros_state``; ``state_from_numpy``
carries a JAX heap state across).  Users that own their own tensors (the
paged KV cache makes its pool on the serving device) use the allocator
alone.  ``scratch`` is the Lemma-1 temporary allocation the ring
all-reduce makes inside the collective, and ``fingerprint`` the registry
digest the tests check it against.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from contextlib import contextmanager
from typing import Iterator, Mapping, Optional, Sequence, Union

import numpy as np
import torch

TeamAxes = Union[str, Sequence[str]]
HeapState = dict  # name -> (n_pe, *shape) tensor

# repro_torch.analysis.shmemcheck hook slot (see core.ordering): None
# when the checker is off.
_checker = None


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or anything numpy understands."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return n * dtype.itemsize


@dataclasses.dataclass(frozen=True)
class SymHandle:
    """A symmetric object: same shape, dtype and *offset* on every PE."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    offset: int          # byte offset in the symmetric address space
    nbytes: int
    align: int = 0       # alignment the object was allocated with
                         # (0 = heap default); realloc's move path
                         # re-places with the same guarantee

    @property
    def addr(self) -> int:
        """The symmetric 'address' — identical on every PE (Fact 1)."""
        return self.offset


@dataclasses.dataclass
class _Block:
    offset: int
    nbytes: int
    free: bool
    name: Optional[str] = None


class SymmetricHeap:
    """Host-side symmetric allocator."""

    DEFAULT_ALIGN = 512  # bytes; the reference's default, kept so that
                         # offsets agree with it

    def __init__(self, team: TeamAxes = ("data", "model"),
                 capacity_bytes: int = 1 << 40):
        self.team = (team,) if isinstance(team, str) else tuple(team)
        self.capacity = int(capacity_bytes)
        self._blocks: list[_Block] = [_Block(0, self.capacity, True)]
        self.registry: dict[str, SymHandle] = {}
        self._scratch_seq = 0
        # sorted (offset, handle) index over live objects: resolve() is
        # a bisect, not a registry scan
        self._sorted_offsets: list[int] = []
        self._sorted_handles: list[SymHandle] = []

    # ------------------------------------------------------------------
    # allocation — shmalloc / shmemalign / shfree (§4.1.1)
    # ------------------------------------------------------------------
    def alloc(self, name: str, shape, dtype,
              align: int | None = None) -> SymHandle:
        """Symmetric allocation: every PE makes this same call with the
        same arguments (the OpenSHMEM requirement, paper §4.1.1)."""
        if name in self.registry:
            raise ValueError(f"symmetric object '{name}' already allocated")
        align = align or self.DEFAULT_ALIGN
        if align & (align - 1):
            raise ValueError(f"alignment must be a power of two, got {align}")
        shape = tuple(int(d) for d in shape)
        dtype = torch_dtype(dtype)
        need = max(_nbytes(shape, dtype), 1)
        for i, blk in enumerate(self._blocks):
            if not blk.free:
                continue
            start = _align_up(blk.offset, align)
            pad = start - blk.offset
            if blk.nbytes >= pad + need:
                self._carve(i, pad, need, name)
                h = SymHandle(name, shape, dtype, start, need, align)
                self.registry[name] = h
                j = bisect.bisect_left(self._sorted_offsets, start)
                self._sorted_offsets.insert(j, start)
                self._sorted_handles.insert(j, h)
                if _checker is not None:
                    _checker.on_alloc(self, h)
                return h
        raise MemoryError(
            f"symmetric heap exhausted: need {need}B aligned {align} "
            f"(capacity {self.capacity}B)")

    def align_alloc(self, name, shape, dtype, align) -> SymHandle:
        """``shmemalign`` (§4.1.1)."""
        return self.alloc(name, shape, dtype, align=align)

    def free(self, handle_or_name) -> None:
        """``shfree`` — symmetric deallocation with coalescing."""
        name = handle_or_name.name if isinstance(handle_or_name, SymHandle) \
            else handle_or_name
        if _checker is not None:
            _checker.on_free(self, name, self.registry.get(name))
        h = self.registry.pop(name, None)
        if h is None:
            raise KeyError(f"no symmetric object named '{name}'")
        j = bisect.bisect_left(self._sorted_offsets, h.offset)
        del self._sorted_offsets[j]
        del self._sorted_handles[j]
        for blk in self._blocks:
            if blk.name == name:
                blk.free, blk.name = True, None
                break
        self._coalesce()

    def realloc(self, handle_or_name, shape, dtype=None,
                align: int | None = None) -> Optional[SymHandle]:
        """``shrealloc`` (§4.1.1): resize a live symmetric object.

        Keeps the offset whenever the resize fits in place — shrink
        splits the block, grow absorbs a free right neighbour — and
        otherwise frees and re-allocates first-fit (the same
        deterministic move on every PE, so the offset stays symmetric).
        Size 0 frees the block and returns ``None``.  Contents are the
        caller's to carry over."""
        name = handle_or_name.name if isinstance(handle_or_name, SymHandle) \
            else handle_or_name
        old = self.registry.get(name)
        if old is None:
            raise KeyError(f"no symmetric object named '{name}'")
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        shape = tuple(int(d) for d in shape)
        if shape and int(np.prod(shape, dtype=np.int64)) == 0:
            self.free(name)
            return None
        dtype = old.dtype if dtype is None else torch_dtype(dtype)
        # validate BEFORE any mutation: a bad argument must not be able
        # to lose the object
        align = align or old.align or None
        if align is not None and align & (align - 1):
            raise ValueError(f"alignment must be a power of two, got {align}")
        need = max(_nbytes(shape, dtype), 1)
        i = next(k for k, blk in enumerate(self._blocks) if blk.name == name)
        blk = self._blocks[i]

        # a STRONGER explicit align than the current offset satisfies
        # rules out resizing in place
        in_place_ok = old.offset % (align or self.DEFAULT_ALIGN) == 0

        if in_place_ok and need <= blk.nbytes:       # in place (shrink/equal)
            rest = blk.nbytes - need
            blk.nbytes = need
            if rest:
                self._blocks.insert(i + 1,
                                    _Block(blk.offset + need, rest, True))
                self._coalesce()
            return self._replace_handle(old, shape, dtype, old.offset, need,
                                        align)

        nxt = self._blocks[i + 1] if i + 1 < len(self._blocks) else None
        grow = need - blk.nbytes
        if in_place_ok and grow > 0 and nxt is not None and nxt.free \
                and nxt.nbytes >= grow:              # absorb neighbour
            blk.nbytes = need
            nxt.offset += grow
            nxt.nbytes -= grow
            if nxt.nbytes == 0:
                del self._blocks[i + 1]
            return self._replace_handle(old, shape, dtype, old.offset, need,
                                        align)

        # move: free then first-fit alloc under the same name
        self.free(name)
        try:
            return self.alloc(name, shape, dtype, align=align)
        except MemoryError:
            # a failed realloc must neither lose nor move the object
            self._alloc_at(old)
            raise

    def _alloc_at(self, h: SymHandle) -> None:
        """Re-carve a just-freed extent at its original offset."""
        for i, blk in enumerate(self._blocks):
            if (blk.free and blk.offset <= h.offset
                    and h.offset + h.nbytes <= blk.offset + blk.nbytes):
                self._carve(i, h.offset - blk.offset, h.nbytes, h.name)
                self.registry[h.name] = h
                j = bisect.bisect_left(self._sorted_offsets, h.offset)
                self._sorted_offsets.insert(j, h.offset)
                self._sorted_handles.insert(j, h)
                if _checker is not None:
                    _checker.on_alloc(self, h)
                return
        raise AssertionError(
            f"extent of '{h.name}' not free during realloc restore")

    def _replace_handle(self, old: SymHandle, shape, dtype, offset: int,
                        nbytes: int, align) -> SymHandle:
        """Swap the registry/index entry for a resized-in-place object."""
        j = bisect.bisect_left(self._sorted_offsets, old.offset)
        del self._sorted_offsets[j]
        del self._sorted_handles[j]
        h = SymHandle(old.name, shape, dtype, offset, nbytes, align or 0)
        self.registry[old.name] = h
        j = bisect.bisect_left(self._sorted_offsets, offset)
        self._sorted_offsets.insert(j, offset)
        self._sorted_handles.insert(j, h)
        if _checker is not None:
            _checker.on_realloc(self, old, h)
        return h

    def _carve(self, i: int, pad: int, need: int, name: str) -> None:
        blk = self._blocks[i]
        pieces = []
        if pad:
            pieces.append(_Block(blk.offset, pad, True))
        pieces.append(_Block(blk.offset + pad, need, False, name))
        rest = blk.nbytes - pad - need
        if rest:
            pieces.append(_Block(blk.offset + pad + need, rest, True))
        self._blocks[i:i + 1] = pieces

    def _coalesce(self) -> None:
        out: list[_Block] = []
        for blk in self._blocks:
            if out and out[-1].free and blk.free:
                out[-1].nbytes += blk.nbytes
            else:
                out.append(blk)
        self._blocks = out

    # ------------------------------------------------------------------
    # Corollary 1 — offset-based remote addressing
    # ------------------------------------------------------------------
    def addr_of(self, name: str) -> int:
        """Symmetric address of an object (same on every PE, Fact 1)."""
        return self.registry[name].offset

    def resolve(self, addr: int) -> tuple[SymHandle, int]:
        """Symmetric address -> (object, byte offset), by bisection."""
        j = bisect.bisect_right(self._sorted_offsets, addr) - 1
        if j >= 0:
            h = self._sorted_handles[j]
            if h.offset <= addr < h.offset + h.nbytes:
                return h, addr - h.offset
        raise KeyError(f"address {addr} not inside any symmetric object")

    # ------------------------------------------------------------------
    # state — the tensors, every PE's copy on one device
    # ------------------------------------------------------------------
    def zeros_state(self, n_pe: int, device=None) -> HeapState:
        """Every live object zeroed, ``(n_pe, *shape)`` on ``device``
        (the card unless the CPU is asked for)."""
        from ..device import resolve
        dev = resolve(device)
        return {h.name: torch.zeros((int(n_pe),) + h.shape, dtype=h.dtype,
                                    device=dev)
                for h in self.registry.values()}

    # ------------------------------------------------------------------
    # Lemma 1 — temporary scratch inside collectives
    # ------------------------------------------------------------------
    @contextmanager
    def scratch(self, shape, dtype, tag: str = "scratch"
                ) -> Iterator[SymHandle]:
        """Temporary symmetric allocation used inside a collective.
        Lemma 1 (paper §4.5.3): it does not break heap symmetry provided
        it is released before the collective returns, which the context
        manager enforces (the registry fingerprint is unchanged after)."""
        name = f"__{tag}_{len(self.registry)}_{self._scratch_counter()}"
        h = self.alloc(name, shape, dtype)
        try:
            yield h
        finally:
            self.free(h)

    def _scratch_counter(self) -> int:
        """Per-instance sequence, so two heaps give the same names."""
        self._scratch_seq += 1
        return self._scratch_seq

    # ------------------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable digest of the registry (names, shapes, dtypes,
        offsets).  Dtypes are spelled as numpy spells them, so the same
        allocation sequence gives the reference's digest."""
        m = hashlib.sha256()
        for name in sorted(self.registry):
            h = self.registry[name]
            m.update(f"{name}:{h.shape}:{_np_name(h.dtype)}:{h.offset}"
                     .encode())
        return m.hexdigest()

    def used_bytes(self) -> int:
        return sum(b.nbytes for b in self._blocks if not b.free)

    def frag_blocks(self) -> int:
        return sum(1 for b in self._blocks if b.free)


def _np_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def state_from_numpy(state_np: Mapping, device=None) -> HeapState:
    """A heap state of numpy arrays with the PE axis first (a JAX heap
    state gathered to the host, ``bfloat16`` included) -> the port's
    state of tensors on ``device`` (the card unless the CPU is asked
    for)."""
    from ..device import resolve
    dev = resolve(device)
    out = {}
    for name, a in state_np.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":        # numpy has no bf16 of its own
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[name] = t.to(dev)
    return out


def _align_up(x: int, a: int) -> int:
    return (x + a - 1) & ~(a - 1)
