"""Gradient bucketing: fewer, larger DP reductions (counterpart of
``repro.comm.bucketing``).

Instead of one allreduce per parameter tensor (hundreds of small,
latency-bound collectives), gradient leaves are packed into flat
buckets of at most ``bucket_bytes`` per PE and reduced bucket by bucket.
Packing turns many small (eager-regime) reductions into few large ones,
which the communicator's dispatch table then routes to the chunked ring.

The stacked layout: every leaf carries the PE axis first, ``(n_pe,
*leaf)``, and a bucket is ``(n_pe, total)``.  Metas and plans are taken
per PE (a leaf's shape and size without the PE axis), so the plan of a
stacked tree equals the reference's plan for one PE's tree.

Reductions route through a ``Communicator`` (``comm.psum``).  A bare
axis name (or axis tuple) builds a default-dispatch communicator for
that team; the port has no enclosing ``shard_map`` to give the team its
size, so the bare form needs ``size=``.

With a heap, each bucket is a temporary symmetric allocation
(``heap.scratch(..., tag="grad_bucket")``), released before the next:
the heap's registry fingerprint is unchanged after the call.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..core.heap import SymmetricHeap
from ..tree import leaves as tree_leaves
from ..tree import tree_map, unflatten
from .communicator import Communicator, DispatchTable

CommLike = Union[Communicator, str, tuple]


def as_communicator(comm_or_axis: CommLike,
                    dispatch: Optional[DispatchTable] = None,
                    size: Optional[int] = None) -> Communicator:
    """A Communicator as it is, or one built for a bare team-axis spec of
    ``size`` PEs."""
    if isinstance(comm_or_axis, Communicator):
        return comm_or_axis
    axis = comm_or_axis if isinstance(comm_or_axis, str) \
        else tuple(comm_or_axis)
    if size is None:
        raise ValueError(
            f"team {axis!r}: a bare axis name needs size= (the port keeps "
            f"every PE on a leading tensor axis; no shard_map gives the "
            f"team its size); or pass a Communicator")
    return Communicator(axis, size=size, dispatch=dispatch,
                        name=f"axis:{axis}")


def leaf_metas(leaves):
    """``(shape, dtype, size)`` of one PE's part of each stacked leaf:
    the packing metadata both the blocking and the overlapped reduction
    paths derive buckets from."""
    return [(tuple(l.shape[1:]), l.dtype, l[0].numel()) for l in leaves]


def unpack_bucket(out, bucket, metas, reduced) -> None:
    """Split a reduced stacked bucket ``(n_pe, total)`` back into its
    leaves (into ``reduced`` at the bucket's indices).  Shared by the
    blocking and overlapped paths so their pack/unpack cannot drift."""
    off = 0
    for i in bucket:
        shape, _, size = metas[i]
        reduced[i] = out[:, off:off + size].reshape((out.shape[0],) + shape)
        off += size


def plan_buckets(metas, bucket_bytes: int) -> list[list[int]]:
    """The bucket plan: leaf indices grouped by dtype (order-preserving)
    and packed greedily up to ``bucket_bytes`` per bucket.  Shared by the
    blocking path below and the overlapped path
    (``repro_torch.train.grad.overlapped_grad_sync``), so the two issue
    the same reductions."""
    by_dtype: dict = {}
    for i, (_, dtype, _) in enumerate(metas):
        by_dtype.setdefault(dtype, []).append(i)
    plan: list[list[int]] = []
    for dtype, idxs in by_dtype.items():
        cap = max(bucket_bytes // dtype.itemsize, 1)
        bucket: list[int] = []
        cur = 0
        for i in idxs:
            if cur + metas[i][2] > cap and bucket:
                plan.append(bucket)
                bucket, cur = [], 0
            bucket.append(i)
            cur += metas[i][2]
        if bucket:
            plan.append(bucket)
    return plan


def pack(leaves, bucket) -> torch.Tensor:
    """The bucket's leaves as one stacked flat ``(n_pe, total)`` tensor:
    a leaf alone in its bucket (one larger than ``bucket_bytes``) as
    itself, reshaped (a view of a contiguous leaf), else a new tensor."""
    flat = [leaves[i].reshape(leaves[i].shape[0], -1) for i in bucket]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)


def tree_allreduce(tree: Any, comm_or_axis: CommLike, *,
                   size: Optional[int] = None):
    """Naive per-leaf allreduce (the unbucketed baseline)."""
    comm = as_communicator(comm_or_axis, size=size)
    return tree_map(comm.psum, tree)


def bucketed_allreduce(tree: Any, comm_or_axis: CommLike, *,
                       bucket_bytes: int = 4 << 20,
                       heap: Optional[SymmetricHeap] = None,
                       size: Optional[int] = None) -> Any:
    """Pack leaves into flat buffers of at most ``bucket_bytes`` per PE
    (per dtype), allreduce each bucket through the communicator, unpack.
    Returns a tree of the same structure."""
    comm = as_communicator(comm_or_axis, size=size)
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    metas = leaf_metas(leaves)
    reduced = [None] * len(leaves)
    for bucket in plan_buckets(metas, bucket_bytes):
        flat = pack(leaves, bucket)
        if heap is not None:
            with heap.scratch(tuple(flat.shape[1:]), flat.dtype,
                              tag="grad_bucket"):
                out = comm.psum(flat)
        else:
            out = comm.psum(flat)
        unpack_bucket(out, bucket, metas, reduced)
    return unflatten(tree, reduced)
