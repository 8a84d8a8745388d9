"""The ``pallas`` communicator backend: the posh schedules with the CUDA
copy engine staging every payload (counterpart of
``repro.comm.pallas_backend``; the name is the reference's, kept so that
callers choose backends by the same strings).

POSH's collectives bottom out in its memcpy engine: every put/get copies
the payload through the variant selected at compile time (§4.4).  This
backend reuses the posh put/get *schedules* (``core.collectives``)
unchanged and installs ``kernels.symm_copy`` as the payload stager for
the duration of each collective, so every payload of every p2p round is
copied by the CUDA kernel (``csrc/symm_copy.cu``) — or, under the
"stock" threshold, by the bare copy, as in the reference.  The variant
is chosen per round from ONE PE's payload bytes and the dtype
(``choose_variant``); the copy itself takes the round's whole stacked
payload in one launch.

With a heap bound to the communicator, the ring schedule allocates its
chunk buffer as a Lemma-1 temporary symmetric allocation, so the heap's
fingerprint is unchanged after the collective.  The stager is an
identity copy, so this backend is bit-exact with "posh".
"""
from __future__ import annotations

import contextlib

from ..core import p2p
from ..kernels import ops
from ..kernels import symm_copy
from .communicator import PoshBackend


class PallasBackend(PoshBackend):
    """posh schedules + the CUDA copy engine as payload transport."""

    name = "pallas"

    def __init__(self, variant: str = "auto"):
        # "auto": per-round size/dtype dispatch; a named variant pins
        # the block for every round (POSH's -D flag)
        self.variant = variant

    # -- the memcpy seam ----------------------------------------------
    def _stage(self, payload):
        """Copy one round's stacked ``(n_pe, *shard)`` payload, the
        variant chosen from one PE's bytes."""
        variant = self.variant
        if variant == "auto":
            variant = symm_copy.choose_variant(
                payload[0].numel() * payload.element_size(), payload.dtype)
        return ops.symm_copy(payload, variant)

    @contextlib.contextmanager
    def _staged(self):
        with p2p.staged_payloads(self._stage):
            yield

    # -- collectives: schedules inherited, transport swapped ----------
    def psum(self, x, team, algo, heap=None):
        with self._staged():
            return super().psum(x, team, algo, heap=heap)

    def pmax(self, x, team, algo):
        with self._staged():
            return super().pmax(x, team, algo)

    def all_gather(self, x, team, algo, *, gather_axis, tiled):
        with self._staged():
            return super().all_gather(x, team, algo, gather_axis=gather_axis,
                                      tiled=tiled)

    def psum_scatter(self, x, team, algo, *, scatter_axis):
        with self._staged():
            return super().psum_scatter(x, team, algo,
                                        scatter_axis=scatter_axis)

    def all_to_all(self, x, team, algo, *, split_axis, concat_axis,
                   team_size):
        with self._staged():
            return super().all_to_all(x, team, algo, split_axis=split_axis,
                                      concat_axis=concat_axis,
                                      team_size=team_size)

    def pbroadcast(self, x, root, team, algo):
        with self._staged():
            return super().pbroadcast(x, root, team, algo)
