"""Zero-downtime weight hot-swap over the symmetric heap — the
counterpart of ``repro.ckpt.hotswap``.

The reference's protocol, step for step:

  1. **Stage** — the new generation is flattened to raw bytes (``_pack``:
     the leaves in ``train.tree.leaves`` order, sorted keys and stacked
     layers, each leaf's bytes as they lie in memory, bf16 included:
     the reference's bytes) and carved into ``row_bytes`` rows over a
     SECOND symmetric allocation ``wstage_g<N>``; the served weights are
     not touched.
  2. **Stream** — each serving tick issues ONE batch of ``chunk_rows``
     rows as a ``put_signal_nbi`` to every PE and retires the PREVIOUS
     batch with a CMP_GE ``signal_wait_until`` on every PE, so batch
     ``i`` is in flight while the tick after its issue computes.  The
     stream runs inside ``CommQueue.phase("swap")`` and never issues a
     fence or a quiet: ``extra_global_drains()`` (``swap_extra_quiets``)
     stays 0.
  3. **Flip** — once every batch has landed on every PE, one
     ``atomic_cswap_nbi`` a PE moves the generation word from the old
     generation to the new, drained by one ``amo_wait``; the engine
     applies the reassembled weights at that tick boundary, before any
     forward of the tick.

Placement.  The packed rows stay on the host (pinned when the streamer
runs on the card), and each batch crosses the bus once, as its put's
issue-time snapshot (``core.ordering.InPlaceTransport``): an
asynchronous copy from the pinned rows on the serving stream, so the
put that lands the batch in the stage, and the flip after the last
batch, come after it in stream order, before the first forward on the
new weights.  The stage is on the streamer's device, one allocation a
PE; the signal and generation words are CPU int64 tensors, as the
other word pads of the port.  ``result()`` returns VIEWS of PE 0's
staged bytes (every leaf whose offset is a multiple of its item size;
a leaf that is not is copied): no second copy of the weights at the
flip, and the other PEs' stages are freed with the streamer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.atomics import amo_wait, atomic_cswap_nbi
from repro_torch.core.heap import SymmetricHeap
from repro_torch.core.ordering import CommQueue, InPlaceTransport
from repro_torch.core.signals import CMP_GE, SignalPad, signal_wait_until
from repro_torch.device import resolve
from repro_torch.train import tree


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _pack(params, *, row_bytes: Optional[int] = None, pin: bool = False):
    """Flatten a parameter tree to ``(payload, specs, treedef)``:
    ``payload`` a 1-D uint8 CPU tensor holding each leaf's bytes back to
    back (the reference's ``_pack`` bytes), zero-padded to whole
    ``row_bytes`` rows (at least one) when ``row_bytes`` is given and in
    pinned memory with ``pin``; ``specs`` each leaf's (shape, dtype);
    ``treedef`` the tree's structure."""
    ls = tree.leaves(params)
    specs = [(tuple(t.shape), t.dtype) for t in ls]
    n = sum(t.numel() * t.element_size() for t in ls)
    total = n if row_bytes is None else max(-(-n // row_bytes), 1) * row_bytes
    payload = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    off = 0
    for t in ls:
        nb = t.numel() * t.element_size()
        payload[off:off + nb].copy_(_bytes_of(t))
        off += nb
    payload[off:].zero_()
    return payload, specs, tree.tree_map(lambda _: None, params)


def _same_bytes(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 28
                ) -> bool:
    """Byte equality of two uint8 tensors, ``chunk`` bytes at a time
    (``torch.equal`` of the whole would allocate a mask of their size)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return a.numel() == b.numel() and all(
        torch.equal(a[i:i + chunk], b[i:i + chunk])
        for i in range(0, a.numel(), chunk))


def _unpack(payload, specs, treedef):
    """Rebuild the tree from staged bytes — the exact inverse of
    ``_pack``, byte for byte in every dtype.  ``payload`` is a 1-D uint8
    tensor (or bytes); a leaf is a view of it where its offset is a
    multiple of its item size, else a copy."""
    if not isinstance(payload, torch.Tensor):
        payload = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    out, off = [], 0
    for shape, dtype in specs:
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        seg = payload[off:off + n]
        if seg.storage_offset() % dtype.itemsize:
            seg = seg.clone()
        out.append(seg.view(dtype).reshape(shape))
        off += n
    return tree.unflatten(treedef, out)


class WeightStreamer:
    """One in-flight hot swap: stages a new parameter generation,
    streams it between serving ticks, flips the generation word.

    ``step()`` is the per-tick hook (``ServeEngine.tick`` calls it before
    scheduling): it advances the stream by one batch and returns True on
    the tick the flip lands; ``result()`` then gives the parameters
    REASSEMBLED FROM THE STAGED BYTES, what crossed the wire, not the
    tree handed in.  ``device=None`` is the GPU."""

    def __init__(self, new_params, *, n_pe: int = 1, generation: int = 1,
                 chunk_rows: int = 4, row_bytes: int = 1 << 14,
                 device=None):
        self.n_pe = max(int(n_pe), 1)
        self.generation = int(generation)
        self.device = resolve(device)
        self.row_bytes = int(row_bytes)
        rows, self._specs, self._treedef = _pack(
            new_params, row_bytes=self.row_bytes,
            pin=self.device.type == "cuda")
        self._nbytes = sum(int(np.prod(s, dtype=np.int64)) * d.itemsize
                           for s, d in self._specs)
        n_rows = rows.numel() // self.row_bytes
        self._rows = rows.view(n_rows, self.row_bytes)

        heap = SymmetricHeap(
            ("data",), capacity_bytes=max(4 * n_rows * self.row_bytes,
                                          1 << 20))
        self.handle = heap.alloc(f"wstage_g{self.generation}",
                                 (n_rows, self.row_bytes), torch.uint8)
        self.gen = heap.alloc("wgen", (1,), torch.int64)
        # at most 2 batches are ever in flight (issue i, retire i-1), so
        # a small recycled pad suffices; signal values strictly grow per
        # word and waits use CMP_GE: no resets
        self.pad = SignalPad(heap, 4, name="wswap_sig")
        state = {
            self.handle.name: [torch.zeros(self.handle.shape,
                                           dtype=torch.uint8,
                                           device=self.device)
                               for _ in range(self.n_pe)],
            self.gen.name: torch.full((self.n_pe, 1), self.generation - 1,
                                      dtype=torch.int64),
            self.pad.handle.name: self.pad.zeros(self.n_pe, device="cpu"),
        }
        self.q = CommQueue(("data",), state,
                           transport=InPlaceTransport(self.n_pe),
                           delivery_seed=0)
        chunk = max(int(chunk_rows), 1)
        self._batches = [(r, min(chunk, n_rows - r))
                         for r in range(0, n_rows, chunk)]
        self._issued = 0
        self._waited = 0
        self.flipped = False
        self.stats = {"batches": len(self._batches), "bytes": self._nbytes,
                      "swap_ticks": 0, "flips": 0}

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Advance the swap by one serving tick: issue the next batch,
        retire the previous one (per-transfer wait, never a quiet), and,
        once everything has landed, flip the generation word.  Returns
        True exactly once, on the flip tick."""
        if self.flipped:
            return False
        self.stats["swap_ticks"] += 1
        with self.q.phase("swap"):
            if self._issued < len(self._batches):
                self._issue(self._issued)
                self._issued += 1
                # overlap: retire only the PREVIOUS batch; the one just
                # issued stays in flight under the serving tick
                if self._waited < self._issued - 1:
                    self._wait(self._waited)
                    self._waited += 1
                return False
            while self._waited < self._issued:
                self._wait(self._waited)
                self._waited += 1
            self._flip()
        self.flipped = True
        self.stats["flips"] += 1
        return True

    def _issue(self, i: int) -> None:
        row0, n = self._batches[i]
        pairs = [(0, d) for d in range(self.n_pe)]
        # PE 0's rows alone are the payload; drained per transfer by
        # _wait's signal_wait_until
        self.q.put_signal_nbi(  # shmem: deferred-drain
            self.handle, self._rows[row0:row0 + n][None], pairs,
            self.pad.handle, i + 1, offset=row0,
            sig_offset=self.pad.word(i))

    def _wait(self, i: int) -> None:
        for pe in range(self.n_pe):
            signal_wait_until(self.q, self.pad.handle, CMP_GE, i + 1,
                              sig_offset=self.pad.word(i), pe=pe)

    def _flip(self) -> None:
        """CAS the generation word on every PE and drain it: the pre-op
        values prove each PE flipped exactly once, from the old
        generation."""
        old = self.generation - 1
        seen = [atomic_cswap_nbi(self.q, self.gen, old, self.generation,
                                 [(0, d)])
                for d in range(self.n_pe)]
        amo_wait(self.q, self.gen, offset=0)
        for d, v in enumerate(seen):
            got = int(v.value())
            if got != old:
                raise RuntimeError(
                    f"hot-swap flip on PE {d}: generation word was {got}, "
                    f"expected {old} — concurrent swap?")

    # ------------------------------------------------------------------
    def result(self):
        """The new parameter tree, reassembled from PE 0's STAGED bytes
        (after checking that every PE staged the same bytes and flipped
        its generation word): views of the stage, on its device."""
        if not self.flipped:
            raise RuntimeError("hot-swap result read before the flip")
        staged = self.q.state[self.handle.name]
        genw = self.q.state[self.gen.name]
        for pe in range(self.n_pe):
            if int(genw[pe, 0]) != self.generation:
                raise RuntimeError(f"PE {pe} generation word is "
                                   f"{int(genw[pe, 0])}, expected "
                                   f"{self.generation}")
            if pe and not _same_bytes(staged[pe], staged[0]):
                raise RuntimeError(f"PE {pe} staged bytes diverge")
        return _unpack(staged[0].reshape(-1)[:self._nbytes], self._specs,
                       self._treedef)

    def extra_global_drains(self) -> int:
        """Fences + quiets attributed to the swap phase: the
        ``swap_extra_quiets`` pin (0: the stream completes on
        per-transfer signal waits and the flip on a per-word
        ``amo_wait``)."""
        ph = self.q.phase_stats("swap")
        return int(ph["quiets"] + ph["fences"])
