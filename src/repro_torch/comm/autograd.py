"""The stacked team's collectives under autograd.

The reference differentiates its collectives with JAX's transpose rules
(inside ``shard_map`` with replication checks off): a psum's cotangent
is psummed, a tiled all_gather's is reduce-scattered, a psum_scatter's
is all-gathered and an all_to_all's goes back by the all_to_all with its
split and concat axes swapped.  Here each is a
``torch.autograd.Function`` whose backward runs that transposed
collective through the SAME ``Communicator`` (its backend, dispatch and
instrumentation), so the backward's traffic is the reference's too: a
posh psum in the forward is a posh psum in the backward.

``Communicator`` takes these on its own when grad mode is on and its
argument requires grad (a training forward, or a checkpointed layer's
recompute); serving and the reductions under ``torch.no_grad`` never
build a graph.
"""
from __future__ import annotations

import torch


class Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.psum(x)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.comm.psum(ct.contiguous())


class AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm.all_gather(x, axis, tiled=True)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.comm.psum_scatter(ct.contiguous(), ctx.axis), None


class PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm.psum_scatter(x, ctx.axis)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.comm.all_gather(ct.contiguous(), ctx.axis,
                                         tiled=True), None


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return comm.all_to_all(x, split_axis=split_axis,
                               concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, ct):
        split_axis, concat_axis = ctx.axes
        return None, ctx.comm.all_to_all(ct.contiguous(),
                                          split_axis=concat_axis,
                                          concat_axis=split_axis), None, None


def wants_grad(comm, x) -> bool:
    """Whether ``comm``'s call on ``x`` must go through autograd: grad
    mode on, ``x`` a tensor that requires grad, a team of more than one
    PE (a one-PE team is the identity, which autograd passes through)."""
    return (comm.size > 1 and isinstance(x, torch.Tensor)
            and x.requires_grad and torch.is_grad_enabled())
